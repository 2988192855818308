"""Roofline terms of the port's programs on an NVIDIA H100 (counterpart
of ``repro/launch/roofline.py``, which reads compiled XLA modules).

    compute term    = sum over dtypes of FLOPs / (chips * peak of that dtype)
    memory term     = bytes / (chips * HBM rate)
    collective term = collective bytes / (chips * link rate)

The port has no compiled module: the count of work comes from one run of
the program under ``analysis.trace.ProgramTrace``.  Its FLOPs are those
of ``torch.utils.flop_counter``'s formulas over the ATen operations, plus
each kernel op's own count from its argument shapes (``qmatmul`` 2 M K
N, ``kv_attention_rows`` 4 B S H W hd over the ring slots its rows read,
no matmul FLOPs for the elementwise kernels), each formula beside its
op's plain version; the ATen operations inside a kernel op are not
counted again.  So the count is the same with the plain versions on the
CPU, with the kernels on the card and on ``meta`` (``program_flops``).
Bytes follow the same rule: every operation's inputs read once and its
outputs written once (a view moves nothing).

Hardware constants: the NVIDIA H100 SXM data sheet at 700 W.  The link
rate is NVLink's per direction, which only a ``ProcessGroupMesh`` across
cards would use: it is not verified here (one card).  The exchange of a
``dist.LocalMesh`` (ranks as threads on one card) moves through device
memory and counts as bytes.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM data sheet (700 W): dense tensor-core rates (bf16,
# TF32, int8), the float32 rate outside the tensor cores, the FP64 tensor
# core rate, device memory and its rate
PEAK_FLOPS = types.MappingProxyType({
    "bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
    "float32": 67e12, "float64": 67e12, "int8": 1979e12})
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9
# NVLink 4, bytes/s a direction; not verified (no multi-card host)
NVLINK_BW = 450e9
NVLINK_VERIFIED = False

# bytes of one element by dtype name (the port's own copy)
DTYPE_BYTES = types.MappingProxyType({
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2, "int64": 8,
    "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1})


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS["float32"]):
    """(least ms on the card, what bounds it) for moving ``nbytes`` and
    doing ``flops`` operations of a type whose peak rate is ``peak``."""
    tb, to = nbytes / HBM_BW, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


@dataclasses.dataclass
class RooflineTerms:
    """Per-chip roofline terms of one program.  ``flops_by_dtype`` maps
    each peak class (``PEAK_FLOPS``) to its FLOPs; ``coll_bytes`` is None
    where no exchange across cards is modelled (``coll_reason`` says
    why)."""
    flops: float                       # per-chip matmul FLOPs
    hbm_bytes: float                   # per-chip bytes moved
    coll_bytes: Optional[float]        # per-chip bytes across cards
    coll_breakdown: Dict[str, float]
    chips: int
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    coll_reason: str = ""

    @property
    def dtype(self) -> str:
        """The program's matmul dtype: the peak class of most FLOPs."""
        if not self.flops_by_dtype:
            return "float32"
        return max(self.flops_by_dtype, key=self.flops_by_dtype.get)

    @property
    def peak(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def t_compute(self) -> float:
        byd = self.flops_by_dtype or {"float32": self.flops}
        return sum(f / PEAK_FLOPS[d] for d, f in byd.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        return None if self.coll_bytes is None \
            else self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective or 0.0}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "peak_flops_per_s": {d: PEAK_FLOPS[d]
                                 for d in (self.flops_by_dtype
                                           or {"float32": 0})},
            "hbm_bytes_per_chip": self.hbm_bytes,
            "hbm_bytes_per_s": HBM_BW,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "collective_note": self.coll_reason or (
                f"NVLink {NVLINK_BW:g} B/s a direction, not verified"),
            "bottleneck": self.bottleneck,
            "chips": self.chips,
        }


def program_flops(fn, *args, **kwargs) -> float:
    """Matmul FLOPs of one call ``fn(*args, **kwargs)``: the same count
    whatever implements the port's kernel ops."""
    from ..analysis.trace import trace_program
    return trace_program(fn, *args, **kwargs)[1].flops


def collective_bytes(record: Sequence) -> Dict[str, float]:
    """Result bytes per primitive of a collective record
    (``analysis.collectives.ExplicitCollective``s)."""
    out: Dict[str, float] = {}
    for c in record:
        out[c.primitive] = out.get(c.primitive, 0.0) + c.nbytes
    return out


def mfu(model_flops_total: float, terms: RooflineTerms) -> float:
    """MODEL_FLOPS / (chips * peak * t_dominant): the roofline fraction,
    at the peak of the program's matmul dtype."""
    t = max(terms.t_compute, terms.t_memory, terms.t_collective or 0.0)
    if t <= 0:
        return 0.0
    return model_flops_total / (terms.chips * terms.peak * t)
