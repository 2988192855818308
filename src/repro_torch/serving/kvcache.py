"""Plan-width quantized KV cache: construction and width resolution
(counterpart of ``repro/serving/kvcache.py``).

:func:`quantized_cache` builds the zeroed container: int8 mantissas on
per-row 2^-f grids (nibble-packed two per byte at ``kv_bits <= 4``) plus
int8 grid-exponent buffers.  Zero mantissas under zero exponents decode
to 0.0, and never-written slots are masked by position anyway.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.plan import NIBBLE_BITS, PrecisionPlan
from ..device import resolve_device
from ..nn.attention import QKVCache

KV_CACHE_MODES = ("fp", "int8", "plan")


def quantized_cache(shape: Tuple[int, ...], kv_bits: int,
                    device=None) -> QKVCache:
    """Zeroed quantized cache for a ``[..., W, KV, hd]`` stack."""
    dev = resolve_device(device)
    hd = shape[-1]
    if kv_bits <= NIBBLE_BITS:
        if hd % 2:
            raise ValueError(f"nibble-packed kv cache needs even head dim, "
                             f"got {hd}")
        hd = hd // 2
    m_shape = tuple(shape[:-1]) + (hd,)
    return QKVCache(k=torch.zeros(m_shape, dtype=torch.int8, device=dev),
                    v=torch.zeros(m_shape, dtype=torch.int8, device=dev),
                    kf=torch.zeros(shape[:-1], dtype=torch.int8, device=dev),
                    vf=torch.zeros(shape[:-1], dtype=torch.int8, device=dev))


def resolve_kv_bits(kv_cache: str,
                    plan: Optional[PrecisionPlan]) -> Optional[int]:
    """Serving KV mode -> mantissa storage width (None = fp cache)."""
    if kv_cache not in KV_CACHE_MODES:
        raise ValueError(f"kv_cache must be one of {KV_CACHE_MODES}, "
                         f"got {kv_cache!r}")
    if kv_cache == "fp":
        return None
    if kv_cache == "int8" or plan is None:
        return 8
    entries = [plan.default, *plan.layers.values()]
    return min(e.kv_bits for e in entries)


def kv_bytes_per_token(n_kv: int, hd: int, n_layers: int,
                       kv_bits: Optional[int]) -> int:
    """Stored self-attention ring bytes per decoded token across layers:
    ``2 * KV * (hd / pack + 1)`` quantized (mantissas plus one exponent
    byte per row), ``2 * KV * hd * 2`` fp (bf16)."""
    if kv_bits is None:
        row = 2 * n_kv * hd * 2
    else:
        row = 2 * n_kv * ((hd // 2 if kv_bits <= NIBBLE_BITS else hd) + 1)
    return row * n_layers
