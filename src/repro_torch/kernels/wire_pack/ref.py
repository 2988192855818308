"""Plain PyTorch versions of the wire compression kernels (counterpart of
``repro/kernels/wire_pack/ref.py``): by definition the elementwise math of
the compressed gradient reduce (``dist.collectives``).

Divisions are true divisions on every device: a float32 tensor divided by
a Python number on CUDA is a multiply by its reciprocal in PyTorch, an ulp
off for ``n`` that is not a power of two, so the divisor here is a tensor
(:func:`true_div`)."""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.quantizer import _exp2i
from ..qmatmul.ops import grid_exponent, mantissa_max, pack_nibbles


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on the CPU and on the card alike."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def grid_scale(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-row wire grid step ``2^-f`` = ``_exp2i(-grid_exponent(amax))``:
    the one scale phase 1 quantizes on and phase 2 decodes with."""
    return _exp2i(-grid_exponent(amax, bits))


def quantize_leaf_ref(rows: torch.Tensor, amax: torch.Tensor, bits: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, P] float32 rows + per-row shared amax [L] -> (int8 mantissas
    [L, P], scale [L], float32 residual ``rows - q * scale``)."""
    rows = rows.to(torch.float32)
    scale = grid_scale(amax, bits)
    qmax = mantissa_max(bits)
    q = torch.clamp(torch.round(rows / scale[:, None]), -qmax,
                    qmax).to(torch.int8)
    residual = rows - q.to(torch.float32) * scale[:, None]
    return q, scale, residual


def quantize_chunks_ref(e: torch.Tensor, s: torch.Tensor, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same with a scale per position (``e`` and ``s`` share a shape)
    -> (int8 mantissas, float32 residual)."""
    e = e.to(torch.float32)
    qmax = mantissa_max(bits)
    q = torch.clamp(torch.round(e / s), -qmax, qmax).to(torch.int8)
    return q, e - q.to(torch.float32) * s


def pack_chunks_ref(q: torch.Tensor) -> torch.Tensor:
    """Two int4-range mantissas per byte along the last axis (odd lengths
    pad one zero nibble): ``qmatmul.pack_nibbles``'s format."""
    return pack_nibbles(q, axis=-1)


def dequant_sum_ref(q: torch.Tensor, s: torch.Tensor, shift: int,
                    n: int) -> torch.Tensor:
    """Phase-2 decode: gathered requantized mantissa sums -> the float32
    delivered mean ``((q * 2^shift) * s) / n``, in that order, with a true
    division; ``s`` broadcasts against ``q``."""
    return true_div(q.to(torch.float32) * (2 ** shift) * s, n)
