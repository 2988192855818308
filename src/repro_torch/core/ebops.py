"""~EBOPs terms of the forward pass (counterpart of ``repro/core/ebops.py``).

EBOPs = sum over multiplications of b_i * b_j (paper SSec. III.C, Eq. 5).
Reductions are separable, ``sum_ij b_x[i] b_w[ij] = <b_x, sum_j b_w>``, so
no [in, out] bit tensor is ever materialized.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _bsum(bits: torch.Tensor, full_shape: Sequence[int], axes) -> torch.Tensor:
    """Sum ``bits`` (broadcastable to full_shape) over ``axes`` without
    materializing the broadcast: multiply by the broadcast multiplicity."""
    bits = torch.as_tensor(bits, dtype=torch.float32)
    full_shape = tuple(full_shape)
    if bits.ndim == 0:
        bits = bits.reshape((1,) * len(full_shape))
    if bits.ndim != len(full_shape):
        raise ValueError(f"bits {tuple(bits.shape)} vs shape {full_shape}")
    mult = 1.0
    reduce_axes = []
    for ax in axes:
        if bits.shape[ax] == 1 and full_shape[ax] != 1:
            mult *= full_shape[ax]
        else:
            reduce_axes.append(ax)
    out = bits.sum(dim=tuple(reduce_axes), keepdim=True) if reduce_axes \
        else bits
    return out * mult


def ebops_matmul(bx: torch.Tensor, bw: torch.Tensor,
                 in_dim: int, out_dim: int) -> torch.Tensor:
    """~EBOPs of ``x @ w``, x [..., in], w [in, out]: ``bx`` broadcastable
    to [in], ``bw`` to [in, out].  Returns a scalar."""
    bx = torch.as_tensor(bx, dtype=torch.float32).reshape(-1)
    bw = torch.as_tensor(bw, dtype=torch.float32)
    if bw.ndim == 0:
        bw = bw.reshape(1, 1)
    if bw.ndim != 2:
        raise ValueError(f"weight bits must be 2-D, got {tuple(bw.shape)}")
    row = _bsum(bw, (bw.shape[0], out_dim), axes=(1,)).reshape(-1)
    if bx.shape[0] == 1 and row.shape[0] == 1:
        return (bx[0] * row[0]) * in_dim
    if bx.shape[0] == 1:
        return bx[0] * row.sum()
    if row.shape[0] == 1:
        return row[0] * bx.sum()
    return torch.dot(bx, row)


def l1_bits(*bit_tensors: torch.Tensor) -> torch.Tensor:
    """L1 regularizer on bitwidths (Eq. 16, gamma term)."""
    tot = torch.zeros((), dtype=torch.float32)
    for b in bit_tensors:
        b = torch.as_tensor(b, dtype=torch.float32)
        tot = tot.to(b.device) + b.sum()
    return tot
