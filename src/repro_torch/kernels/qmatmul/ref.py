"""Plain PyTorch versions of the packed-weight dequant matmul and the
weight packer (counterpart of ``repro/kernels/qmatmul/ref.py``)."""
from __future__ import annotations

import torch

from ...core.quantizer import _exp2i


def qmatmul_ref(x: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] fp; w_int [K, N] int8; scale [N] fp (= 2^-f per channel).
    Dequantize-then-matmul in fp32: ``x @ (w_int * scale)``.  On the card
    it runs in full fp32 (TF32 off)."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
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
