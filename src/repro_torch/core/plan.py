"""PrecisionPlan: the per-layer width table (counterpart of
``repro/core/plan.py``), JSON-exact so the JAX package's plan files load.

A :class:`PrecisionPlan` maps ``/``-joined params-tree paths to
:class:`LayerPlan` widths: ``wire_bits`` (gradient collective),
``pack_bits`` (serving weight pack; <= 4 nibble-packs two mantissas per
byte), ``kv_bits`` (serving KV cache rows) and ``scale_exp`` (reported
grid exponent).  ``PrecisionPlan()`` is uniform int8.  Deriving a plan
from trained weights (``plan_from_params``) and its reporting helpers
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Optional

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
