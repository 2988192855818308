"""PrecisionPlan: the per-layer width table (counterpart of
``repro/core/plan.py``), JSON-exact so the JAX package's plan files load.

A :class:`PrecisionPlan` maps ``/``-joined params-tree paths to
:class:`LayerPlan` widths: ``wire_bits`` (gradient collective),
``pack_bits`` (serving weight pack; <= 4 nibble-packs two mantissas per
byte), ``kv_bits`` (serving KV cache rows) and ``scale_exp`` (reported
grid exponent).  ``PrecisionPlan()`` is uniform int8.
``plan_from_params`` derives a plan from trained weights (the occupied
bits of each packable layer), ``mixed_low_plan`` puts every packable
layer at a low width, and ``wire_bits_tree`` feeds per-leaf widths to the
compressed gradient reduce.  The sweep and reporting helpers are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import torch

MIN_BITS, MAX_BITS = 4, 8
NIBBLE_BITS = 4     # widths <= this pack two mantissas per stored byte


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Widths of one layer (a params-tree prefix, e.g. ``d0/kernel``)."""
    wire_bits: int = 8
    pack_bits: int = 8
    scale_exp: Optional[float] = None
    kv_bits: int = 8

    def __post_init__(self):
        for name in ("wire_bits", "pack_bits", "kv_bits"):
            v = getattr(self, name)
            _check(MIN_BITS <= v <= MAX_BITS,
                   f"LayerPlan.{name} must be in "
                   f"[{MIN_BITS}, {MAX_BITS}], got {v!r}")


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Frozen per-layer width table; ``default`` covers unlisted leaves.
    An entry applies to every leaf at or under its path, deepest match
    winning."""
    default: LayerPlan = dataclasses.field(default_factory=LayerPlan)
    layers: Dict[str, LayerPlan] = dataclasses.field(default_factory=dict)

    def entry_for(self, key: str) -> LayerPlan:
        """The deepest ``layers`` entry whose path is ``key`` or a
        ``/``-prefix of it; ``default`` otherwise."""
        best, best_len = self.default, -1
        for k, entry in self.layers.items():
            if (key == k or key.startswith(k + "/")) and len(k) > best_len:
                best, best_len = entry, len(k)
        return best

    @property
    def is_uniform_int8(self) -> bool:
        """True when every leaf resolves to 8-bit wire and pack: the plan
        is a no-op and consumers take the uniform int8 path."""
        entries = [self.default, *self.layers.values()]
        return all(e.wire_bits == 8 and e.pack_bits == 8 for e in entries)

    def wire_bits_tree(self, tree: Any) -> Any:
        """A matching tree of per-leaf wire widths (plain ints) for a
        params or gradient tree: what ``dist.collectives`` consumes."""
        from ..tree import tree_flatten_with_path, tree_unflatten
        return tree_unflatten(tree, [
            self.entry_for(path_key(path)).wire_bits
            for path, _ in tree_flatten_with_path(tree)])

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PrecisionPlan":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        _check(not unknown, f"unknown PrecisionPlan fields: "
                            f"{sorted(unknown)}")
        entry_known = {f.name for f in dataclasses.fields(LayerPlan)}

        def entry(e: Dict[str, Any]) -> LayerPlan:
            bad = set(e) - entry_known
            _check(not bad, f"unknown LayerPlan fields: {sorted(bad)}")
            return LayerPlan(**e)

        if isinstance(d.get("default"), dict):
            d["default"] = entry(d["default"])
        if isinstance(d.get("layers"), dict):
            d["layers"] = {k: entry(v) for k, v in d["layers"].items()}
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "PrecisionPlan":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "PrecisionPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def path_key(path: Iterable[Any]) -> str:
    """A params-tree path (dict keys / list indices) -> the ``/``-joined
    plan key (``d0/kernel/w``)."""
    return "/".join(str(k) for k in path)


def packable_weight(name: str, w) -> bool:
    """The one packable-matmul-weight rule: rank >= 2 floating weights
    that are not biases and not conv kernels."""
    if not isinstance(w, torch.Tensor) or w.ndim < 2:
        return False
    if not w.is_floating_point():
        return False
    if name == "bias":
        return False          # stacked biases are [L, d] but not matmuls
    if name == "kernel" and w.ndim >= 4:
        return False          # conv kernels
    return True


def iter_packable(params: Any) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """``(plan_key, weight_dict)`` for every packable matmul weight dict
    ``{'w', 'f'?}`` of a params tree, in walk (insertion) order; the keys
    are the paths :meth:`PrecisionPlan.entry_for` matches."""
    def walk(obj, prefix: Tuple[str, ...]):
        if isinstance(obj, dict):
            name = prefix[-1] if prefix else ""
            if "w" in obj and packable_weight(name, obj["w"]):
                yield "/".join(prefix), obj
                return
            for k, v in obj.items():
                yield from walk(v, prefix + (str(k),))
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                yield from walk(v, prefix + (str(i),))
    yield from walk(params, ())


def layer_occupied_bits(w: torch.Tensor,
                        f: Optional[torch.Tensor] = None) -> int:
    """Mantissa bits one layer occupies on the capped per-channel grid of
    ``qmatmul.channel_bits``: the widest channel's ``|mantissa|`` plus the
    sign bit, an int in [1, 8]."""
    from ..kernels.qmatmul.ops import channel_bits
    from .quantizer import _exp2i
    w32 = w.to(torch.float32)
    fi = channel_bits(w32, f)
    amax = torch.amax(torch.abs(w32), dim=-2)
    m = int(torch.max(torch.floor(amax * _exp2i(fi) + 0.5)))
    return max(m.bit_length() + 1, 1)


def plan_from_params(params: Any, *, low_bits: int = 4,
                     threshold: Optional[int] = None) -> PrecisionPlan:
    """A plan from a trained params tree: a packable layer whose occupied
    bits are at or below ``threshold`` (default ``low_bits``) gets
    ``low_bits`` wire and pack widths, every other layer int8;
    ``scale_exp`` records the layer's largest per-channel grid exponent.
    Unlisted leaves keep the 8-bit default."""
    from ..kernels.qmatmul.ops import channel_bits
    _check(MIN_BITS <= low_bits <= MAX_BITS,
           f"low_bits must be in [{MIN_BITS}, {MAX_BITS}], got {low_bits!r}")
    thr = low_bits if threshold is None else threshold
    layers: Dict[str, LayerPlan] = {}
    for key, p in iter_packable(params):
        w = p["w"].to(torch.float32)
        f = p.get("f")
        b = layer_occupied_bits(w, f)
        exp = float(torch.max(channel_bits(w, f)))
        bits = low_bits if b <= thr else 8
        layers[key] = LayerPlan(wire_bits=bits, pack_bits=bits,
                                scale_exp=exp)
    return PrecisionPlan(layers=layers)


def mixed_low_plan(params: Any, low_bits: int = 4) -> PrecisionPlan:
    """Every packable matmul layer at ``low_bits``, everything else at the
    8-bit default: the widest mixed plan a params tree supports."""
    return PrecisionPlan(layers={
        key: LayerPlan(wire_bits=low_bits, pack_bits=low_bits)
        for key, _ in iter_packable(params)})
