"""Plain PyTorch versions of the packed-weight dequant matmul and the
weight packer (counterpart of ``repro/kernels/qmatmul/ref.py``)."""
from __future__ import annotations

import torch

from ...core.quantizer import _exp2i
from .._work import nbytes, rows_of


def unpack_nibbles(packed: torch.Tensor, orig: int,
                   axis: int = -1) -> torch.Tensor:
    """Inverse of ``ops.pack_nibbles``: sign-extended mantissas by
    arithmetic shifts."""
    p = torch.movedim(packed.to(torch.int8), axis, -1)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    m = torch.stack([lo, hi], dim=-1).reshape(
        p.shape[:-1] + (2 * p.shape[-1],))[..., :orig]
    return torch.movedim(m, -1, axis)


def qmatmul_ref(x: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor, nib: bool = False) -> torch.Tensor:
    """x [M, K] fp; w_int [K, N] int8, or with ``nib`` the packed storage
    [K / 2, N] (two int4 mantissas a byte along K, the even k in the low
    nibble); scale [N] fp (= 2^-f per channel).  Dequantize-then-matmul
    in fp32: ``x @ (w_int * scale)``.  On the card it runs in full fp32
    (TF32 off)."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    if nib:
        w_int = unpack_nibbles(w_int, 2 * w_int.shape[0], axis=0)
    w = w_int.to(torch.float32) * scale.to(torch.float32)[None, :]
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def pack_ref(w: torch.Tensor, f: torch.Tensor, bits: int = 8):
    """fp weights [..., K, N] + fractional bits f [..., N] -> (``bits``-wide
    int8-stored mantissas, [..., N] scale = 2^-fi).  Sub-8-bit grids clip
    symmetrically to +-(2^(b-1)-1)."""
    fi = torch.floor(f.to(torch.float32) + 0.5)
    scale = _exp2i(-fi)
    lo, hi = (-128, 127) if bits == 8 else \
        (-(2 ** (bits - 1) - 1), 2 ** (bits - 1) - 1)
    m = torch.clamp(torch.floor(w.to(torch.float32) / scale[..., None, :]
                                + 0.5), lo, hi).to(torch.int8)
    return m, scale


def bf16_split3(x: torch.Tensor):
    """fp32 ``x`` -> three bfloat16 terms (each the round-to-nearest of
    what the terms before it left), the activation split of the
    ``qmatmul`` kernel: ``hi + mid + lo == x`` exactly for every normal
    x whose lowest term stays normal, and every term times an int8 or int4
    mantissa is exact in fp32."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def qmatmul_work(out, x: torch.Tensor, w_int: torch.Tensor,
                 scale: torch.Tensor, *, nib: bool = False):
    """The op's work (``kernels._work``): 2 M K N FLOPs for ``x [..., K]``
    (M rows) times the [K, N] weight, the bytes of x, the stored weight
    as it lies (int8 or nibble pairs), the scale and the output."""
    K, N = x.shape[-1], w_int.shape[1]
    return (2.0 * rows_of(x) * K * N, nbytes(x, w_int, scale, out), ())
