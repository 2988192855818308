"""~EBOPs terms and the Eq.-16 loss (counterpart of ``repro/core/ebops.py``).

EBOPs = sum over multiplications of b_i * b_j (paper SSec. III.C, Eq. 5).
The terms here are the differentiable ~EBOPs of training: bits =
relu(i' + f) from running extremes, which upper-bound the exact count.
Reductions are separable, ``sum_ij b_x[i] b_w[ij] = <b_x, sum_j b_w>``, so
no [in, out] bit tensor is ever materialized.  ``useful_model_flops_dense``
counts a dense model's training operations for an MFU line.
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


def ebops_conv2d(bx: torch.Tensor, bw: torch.Tensor,
                 w_shape: Sequence[int]) -> torch.Tensor:
    """~EBOPs of a conv2d with kernel [kh, kw, cin, cout], stream-IO
    counting (paper SSec. V.A / V.C): each kernel weight is one physical
    multiplier, counted once.  ``bx`` broadcastable to [cin], ``bw`` to
    w_shape."""
    kh, kw, cin, cout = w_shape
    bw = torch.as_tensor(bw, dtype=torch.float32)
    if bw.ndim == 0:
        bw = bw.reshape(1, 1, 1, 1)
    per_cin = _bsum(bw, (kh, kw, cin, cout), axes=(0, 1, 3)).reshape(-1)
    bx = torch.as_tensor(bx, dtype=torch.float32).reshape(-1)
    if bx.shape[0] == 1 and per_cin.shape[0] == 1:
        return bx[0] * per_cin[0] * cin
    if bx.shape[0] == 1:
        return bx[0] * per_cin.sum()
    if per_cin.shape[0] == 1:
        return per_cin[0] * bx.sum()
    return torch.dot(bx, per_cin)


def ebops_dyn_matmul(ba: torch.Tensor, bb: torch.Tensor,
                     a_shape: Sequence[int], b_shape: Sequence[int]
                     ) -> torch.Tensor:
    """~EBOPs of a variable x variable matmul A[m, k] @ B[k, n] (e.g.
    Q.K^T): sum_k (sum_m ba)[k] * (sum_n bb)[k], ``ba``/``bb``
    broadcastable to the trailing two axes of a_shape/b_shape."""
    m, k = a_shape[-2], a_shape[-1]
    k2, n = b_shape[-2], b_shape[-1]
    if k != k2:
        raise ValueError(f"inner dims differ: {a_shape} @ {b_shape}")
    ba = torch.as_tensor(ba, dtype=torch.float32)
    bb = torch.as_tensor(bb, dtype=torch.float32)
    ba = ba.reshape((1, 1) if ba.ndim == 0 else ba.shape[-2:])
    bb = bb.reshape((1, 1) if bb.ndim == 0 else bb.shape[-2:])
    a_k = _bsum(ba, (m, k), axes=(0,)).reshape(-1)
    b_k = _bsum(bb, (k, n), axes=(1,)).reshape(-1)
    if a_k.shape[0] == 1 and b_k.shape[0] == 1:
        return a_k[0] * b_k[0] * k
    if a_k.shape[0] == 1:
        return a_k[0] * b_k.sum()
    if b_k.shape[0] == 1:
        return b_k[0] * a_k.sum()
    return torch.dot(a_k, b_k)


def l1_bits(*bit_tensors: torch.Tensor) -> torch.Tensor:
    """L1 regularizer on bitwidths (Eq. 16, gamma term)."""
    tot = torch.zeros((), dtype=torch.float32)
    for b in bit_tensors:
        b = torch.as_tensor(b, dtype=torch.float32)
        tot = tot.to(b.device) + b.sum()
    return tot


def loss_with_resource(base_loss: torch.Tensor, ebops: torch.Tensor,
                       l1: torch.Tensor, beta, gamma) -> torch.Tensor:
    """Eq. (16): L = L_base + beta * ~EBOPs + gamma * L1_norm."""
    return base_loss + beta * ebops + gamma * l1


def useful_model_flops_dense(n_params: int, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D (dense): the useful operations of a training
    step over D tokens, the numerator of an MFU line."""
    return 6.0 * float(n_params) * float(n_tokens)
