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


def _kv_row_bytes(n_kv: int, hd: int, kv_bits: Optional[int]) -> int:
    """Stored bytes of one K+V cache row (one token or one memory frame,
    one layer): ``2 * KV * (hd / pack + 1)`` quantized (mantissas plus
    one grid-exponent byte), ``2 * KV * hd * 2`` fp (bf16)."""
    if kv_bits is None:
        return 2 * n_kv * hd * 2
    return 2 * n_kv * ((hd // 2 if kv_bits <= NIBBLE_BITS else hd) + 1)


def kv_bytes_per_token(n_kv: int, hd: int, n_layers: int,
                       kv_bits: Optional[int]) -> int:
    """Stored self-attention ring bytes per decoded token across layers
    (an encoder-decoder model's cross memory is a static cost a request:
    :func:`kv_cross_bytes_per_request`)."""
    return _kv_row_bytes(n_kv, hd, kv_bits) * n_layers


def kv_cross_bytes_per_request(n_kv: int, hd: int, n_layers: int,
                               frames: int,
                               kv_bits: Optional[int]) -> int:
    """Stored cross-attention memory bytes one encoder-decoder request
    pins for its lifetime: ``frames`` K+V rows a decoder layer, written
    once as the audio streams in, on the self ring's grids when
    ``kv_bits`` is set."""
    return _kv_row_bytes(n_kv, hd, kv_bits) * n_layers * frames
