"""Declarative invariant rules over program artifacts (counterpart of
``repro/analysis/rules.py``: the same names, applicability and
messages, retargeted where the port's program differs).

Each :class:`Rule` is (name, doc, applies?, check): ``check`` returns
:class:`Violation`\\ s, an empty list means the invariant holds.  The
registry ``PROGRAM_RULES`` is an immutable tuple so the module passes
the repo's own no-module-level-mutable-state gate without allowlisting.

Where the reference reads a compiled module, the port reads one traced
run (``analysis.trace``):

* the dtype-flow rules run over the collectives the program's meshes
  issued (``analysis.collectives``) -- in the port every collective is
  one the code wrote, there is no compiler-inserted traffic;
* ``no-f64`` forbids float64 in the program's state and across its
  boundary (params, optimizer moments, EF residuals, caches, wire
  payloads, the tensors the program returns) and any float64 operation
  outside the three modules that sum in float64 on purpose
  (``trace.F64_SITES``);
* ``donation`` and ``decode-donation`` read the storages the run wrote
  in place (the port's input-output aliases);
* ``packed-weights`` and ``quantized-kv`` read the program's parameter
  and cache tensors by dtype (the reference's entry parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

from .program import ProgramArtifacts
from .trace import F64_SITES

# Results smaller than this are scalar-class traffic (loss / gnorm
# scalars, per-leaf amax rows) for the dtype-flow rules; a gradient-sized
# leaf is always far above it.
SCALAR_MAX = 256

_INT_DTYPES = ("int8", "uint8")


def _wire_payload(kind: str) -> Tuple[str, ...]:
    """Dtype names a wire payload may travel as: int8 grads / nibble
    pairs (int8 bytes in the port, uint8 in the reference) for the int8
    kinds, bf16 for the bf16 wire."""
    return ("bfloat16",) if kind == "bf16" else _INT_DTYPES


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    program: str
    message: str

    def __str__(self) -> str:
        return f"{self.program}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    applies: Callable[[ProgramArtifacts], bool]
    check: Callable[[ProgramArtifacts], List[Violation]]

    def run(self, art: ProgramArtifacts) -> List[Violation]:
        return self.check(art) if self.applies(art) else []


def _is_wire_train(art: ProgramArtifacts) -> bool:
    return (art.kind == "train" and bool(art.meta.get("wire"))
            and art.mesh_shape[0] * art.mesh_shape[1] > 1)


# -- dtype-flow ----------------------------------------------------------

def _scalar_limit(art: ProgramArtifacts) -> int:
    """Elements below which a collective is scalar-class: ``SCALAR_MAX``,
    or one value a quantization row of the gradient tree and one more
    (the amax pmax carries a value a row: 357 rows at qwen2-0.5b's full
    width, past ``SCALAR_MAX``, and still O(layers), not O(params))."""
    return max(SCALAR_MAX, art.meta.get("scale_rows", 0) + 1)


def _check_wire_dtypes(art: ProgramArtifacts) -> List[Violation]:
    """Every collective moving more than scalar-class traffic must carry
    the plan's wire payload dtype -- a gradient-sized f32 exchange is
    exactly the silent-upcast leak HGQ exists to prevent.  Scalar-class
    traffic (the amax pmax, loss/gnorm scalars) may stay f32: it is
    O(layers), not O(params) (``_scalar_limit``)."""
    allowed = _wire_payload(art.meta.get("wire_payload", "int8"))
    limit = _scalar_limit(art)
    out = []
    for c in art.explicit_collectives():
        if c.numel < limit:
            continue
        if c.dtype not in allowed:
            out.append(Violation(
                "wire-dtype", art.name,
                f"{c.primitive} over {c.axes} moves {c.dtype}"
                f"{list(c.dims)} ({c.numel} elems) — wire payload must "
                f"be one of {allowed}; scalar-class f32 is only allowed "
                f"under {limit} elems"))
    return out


def _check_wire_present(art: ProgramArtifacts) -> List[Violation]:
    """A wire-compressed step with no payload collective over the data
    axis means the exchange silently fell back to a dense path -- the
    compression did nothing."""
    allowed = _wire_payload(art.meta.get("wire_payload", "int8"))
    if art.mesh_shape[0] == 1:
        return []          # no data axis to exchange over
    for c in art.explicit_collectives():
        if c.over("data") and c.dtype in allowed and c.numel >= SCALAR_MAX:
            return []
    return [Violation(
        "wire-present", art.name,
        f"no explicit {allowed} collective over the data axis — the "
        f"compressed wire exchange is missing from the traced program")]


def _check_no_f64(art: ProgramArtifacts) -> List[Violation]:
    """Float64 in the program's state or across its boundary means x64
    leaked in -- every HGQ width fits in f32/bf16/intN and doubles would
    silently halve throughput; a float64 operation outside the modules
    that sum in float64 on purpose is a leak too."""
    out = []
    roles = sorted({role for role, dtype, _ in art.state()
                    if dtype == "float64"})
    if roles:
        out.append(Violation(
            "no-f64", art.name,
            f"float64 tensors in the program's {', '.join(roles)}"))
    wire = sorted({c.primitive for c in art.explicit_collectives()
                   if c.dtype == "float64"})
    if wire:
        out.append(Violation(
            "no-f64", art.name,
            f"float64 wire payload in {', '.join(wire)}"))
    stray = {m: n for m, n in art.f64_ops().items() if m not in F64_SITES}
    if stray:
        out.append(Violation(
            "no-f64", art.name,
            f"float64 operations outside {F64_SITES}: "
            + ", ".join(f"{m} ({n})" for m, n in sorted(stray.items()))))
    return out


# -- donation / aliasing -------------------------------------------------

def _check_donation(art: ProgramArtifacts) -> List[Violation]:
    """Donated buffers (params, optimizer mu/nu, EF residual) must be
    updated in place -- returned in their own storage and written; a
    dropped donation doubles peak memory for that tree silently."""
    want = art.meta.get("donated_leaves", 0)
    got = art.aliased_buffers()
    if got < want:
        return [Violation(
            "donation", art.name,
            f"the step updates {got} buffers in place, but at least {want} "
            f"donated leaves (params + opt.mu/nu + EF residual) must "
            f"round-trip in place")]
    return []


def _check_decode_donation(art: ProgramArtifacts) -> List[Violation]:
    """The decode tick writes its KV/state cache tree in place; a cache
    leaf returned in a new storage (or none written in place) means every
    token copies the full cache."""
    moved = art.moved_buffers()
    if art.aliased_buffers() == 0 or moved:
        return [Violation(
            "decode-donation", art.name,
            f"decode step writes no cache leaf in place ({moved} returned "
            f"in new storage) — the KV/state cache is being copied every "
            f"token")]
    return []


# -- packed serving ------------------------------------------------------

def _check_packed_weights(art: ProgramArtifacts) -> List[Violation]:
    """A packed-serving program must actually take its weights as integer
    tensors: f32 parameter bytes at or above the unpacked tree size mean
    the pack was dropped."""
    int_bytes = f32_bytes = 0
    for role, dtype, n in art.state(outputs=False):
        if role != "params":
            continue
        if dtype in _INT_DTYPES:
            int_bytes += n
        elif dtype == "float32":
            f32_bytes += 4 * n
    out = []
    if int_bytes == 0:
        out.append(Violation(
            "packed-weights", art.name,
            "packed_serving spec but the decode program has no integer "
            "weight parameters"))
    unpacked = art.meta.get("unpacked_param_bytes", 0)
    if unpacked and f32_bytes >= unpacked:
        out.append(Violation(
            "packed-weights", art.name,
            f"f32 parameter bytes ({f32_bytes}) >= unpacked tree size "
            f"({unpacked}) — weights are not being served packed"))
    return out


# -- quantized KV cache --------------------------------------------------

def _check_quantized_kv(art: ProgramArtifacts) -> List[Violation]:
    """A quantized-KV decode program must store its ring buffer at the
    plan's KV byte widths: the integer tensors it takes account for the
    cache bytes the engine allocated, and no cache-class (>= SCALAR_MAX
    elems) bf16 tensor exists -- a bf16 buffer here is exactly the hidden
    fp spill the spec was meant to remove."""
    inputs = art.state(outputs=False)
    want = art.meta.get("kv_cache_int_bytes", 0)
    int_bytes = sum(n for _, dtype, n in inputs if dtype in _INT_DTYPES)
    out = []
    if int_bytes < want:
        out.append(Violation(
            "quantized-kv", art.name,
            f"integer input bytes ({int_bytes}) < the engine's quantized "
            f"cache allocation ({want}) — the KV ring buffer is not stored "
            f"at plan widths"))
    spilled = [n for _, dtype, n in inputs
               if dtype == "bfloat16" and n >= SCALAR_MAX]
    if spilled:
        out.append(Violation(
            "quantized-kv", art.name,
            f"bf16 tensors of cache class remain "
            f"({sorted(spilled, reverse=True)[:4]} elems) — the fp KV "
            f"cache is spilling alongside the quantized one"))
    return out


PROGRAM_RULES: Tuple[Rule, ...] = (
    Rule("wire-dtype",
         "explicit collectives above scalar class (SCALAR_MAX elems, or "
         "one a quantization row of the tree) carry the wire payload "
         "dtype (int8 / nibble pairs, or bf16), never f32",
         _is_wire_train, _check_wire_dtypes),
    Rule("wire-present",
         "a wire-compressed step has an explicit payload collective "
         "over the data axis (no silent dense fallback)",
         _is_wire_train, _check_wire_present),
    Rule("no-f64",
         "no float64 in program state or across its boundary (params, "
         "moments, residuals, caches, wire payloads, returned tensors), "
         "and float64 operations only from the modules that sum in "
         "float64 on purpose (nn.basic, nn.recurrent, core.fixedpoint)",
         lambda art: True, _check_no_f64),
    Rule("donation",
         "donated train buffers (params, opt.mu/nu, EF residual) are "
         "updated in place: their storage unchanged across the step, and "
         "written",
         lambda art: art.kind == "train", _check_donation),
    Rule("decode-donation",
         "the decode tick writes its cache tree in place",
         lambda art: art.kind == "decode", _check_decode_donation),
    Rule("packed-weights",
         "packed-serving programs take integer weight tensors and never "
         "hold the f32 tree",
         lambda art: art.kind == "decode" and art.meta.get("packed"),
         _check_packed_weights),
    Rule("quantized-kv",
         "quantized-KV decode programs store the ring buffer at plan "
         "KV byte widths with no cache-class bf16 spill",
         lambda art: art.kind == "decode" and art.meta.get("kv_bits"),
         _check_quantized_kv),
)


def run_rules(art: ProgramArtifacts,
              rules: Tuple[Rule, ...] = PROGRAM_RULES) -> List[Violation]:
    out = []
    for rule in rules:
        out.extend(rule.run(art))
    return out
