"""Compute-dtype casting and HGQ serving-weight packing (counterpart of
``repro/dist/perf.py``).

Compute dtype: layers call :func:`cast_for_matmul` on matmul operands;
the dtype is scoped (:func:`compute_dtype_scope`, over ``dist.scope``),
and the unscoped default is ``None``: no cast, float32 stays float32.

:func:`pack_params_for_serving` rewrites every matmul weight dict
``{'w', 'f'}`` into ``{'w_int8', 'scale', 'f'}`` (or ``{'w_nib', ...}``,
two int4 mantissas per byte along K, for plan layers of <= 4 bits): int8
mantissas plus a per-output-channel 2^-f scale, the representation the
``qmatmul`` kernel consumes.  The port has no packed-routing flag: a
packed weight always goes through ``qmatmul``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.plan import NIBBLE_BITS, packable_weight
from ..kernels.qmatmul.ops import pack_linear, pack_nibbles, unpack_nibbles
from .scope import Scoped

_COMPUTE: Scoped[Optional[torch.dtype]] = Scoped("repro_torch.compute_dtype",
                                                 None)


def compute_dtype_scope(dtype: Optional[torch.dtype]):
    """Context manager: run the enclosed computation with ``dtype`` as the
    matmul compute dtype (``None`` = no cast); restores on exit."""
    return _COMPUTE.scope(dtype)


def reset_precision() -> None:
    """Back to the no-cast default (tests)."""
    _COMPUTE.reset_default()


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE.get()


def cast_for_matmul(x: torch.Tensor) -> torch.Tensor:
    """Cast a floating matmul operand to the compute dtype, if one is set."""
    dtype = _COMPUTE.get()
    if dtype is None or not x.is_floating_point():
        return x
    return x.to(dtype)


def _pack_one(p: Dict[str, Any], bits: int = 8,
              n_major: bool = False) -> Dict[str, Any]:
    """One weight dict {'w', 'f'?} -> {'w_int8' | 'w_nib', 'scale', 'f'?};
    scale keeps a broadcastable ``[..., 1, N]`` shape.  Odd-K layers keep
    int8 storage on the narrow grid.  ``n_major`` stores the mantissas of
    each output channel contiguously (same shape and values, transposed
    strides)."""
    m, scale = pack_linear(p["w"], p.get("f"), bits)
    out: Dict[str, Any] = {"scale": scale[..., None, :].to(torch.float32)}
    if bits <= NIBBLE_BITS and m.shape[-2] % 2 == 0:
        key, stored = "w_nib", pack_nibbles(m, axis=-2)
    else:
        key, stored = "w_int8", m
    if n_major:
        stored = stored.transpose(-1, -2).contiguous().transpose(-1, -2)
    out[key] = stored
    if p.get("f") is not None:
        out["f"] = p["f"]
    return out


def pack_params_for_serving(params: Any, plan=None) -> Any:
    """Rewrite matmul weights to mantissas + per-channel scale at each
    layer's ``plan`` pack width (uniform int8 when ``plan`` is None);
    structure-preserving everywhere else.

    Dense kernels (``.../kernel``) are stored N-major, each output
    channel's K mantissas contiguous: the layout the ``qmatmul`` kernel
    streams fastest.  The embedding table stays row-major: decode gathers
    its rows, and its transpose, the tied head's weight, is N-major
    already.  Values and shapes are the JAX package's either way."""
    def walk(obj, name="", prefix=()):
        if isinstance(obj, dict):
            if "w" in obj and packable_weight(name, obj["w"]):
                bits = 8 if plan is None else \
                    plan.entry_for("/".join(prefix)).pack_bits
                return _pack_one(obj, bits, n_major=name == "kernel")
            return {k: walk(v, k, prefix + (str(k),))
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v, name, prefix + (str(i),))
                    for i, v in enumerate(obj)]
        return obj
    return walk(params)


def packed_storage(p: Dict[str, Any]) -> Tuple[torch.Tensor, bool]:
    """(stored mantissas as they lie, whether they are nibbles): ``w_int8``
    ``[..., K, N]`` or ``w_nib`` ``[..., K / 2, N]``, the form the
    ``qmatmul`` kernel reads without unpacking."""
    if "w_nib" in p:
        return p["w_nib"], True
    return p["w_int8"], False


def packed_mantissas(p: Dict[str, Any]) -> torch.Tensor:
    """Full-width int8 mantissas ``[..., K, N]`` of a packed weight dict
    (``w_nib`` sign-extend unpacked along K)."""
    if "w_nib" in p:
        nib = p["w_nib"]
        return unpack_nibbles(nib, 2 * nib.shape[-2], axis=-2)
    return p["w_int8"]


def is_packed(p: Any) -> bool:
    """True for a serving-packed weight dict (either storage format)."""
    return isinstance(p, dict) and ("w_int8" in p or "w_nib" in p)


def unpack_weight(p: Dict[str, Any]) -> torch.Tensor:
    """Dequantize a packed weight dict to fp32."""
    return packed_mantissas(p).to(torch.float32) * \
        p["scale"].to(torch.float32)
