"""Bit-exact fixed-point emulation, the "proxy model" of paper SSec. IV
(counterpart of ``repro/core/fixedpoint.py``).

Emulates AMD Vivado/Vitis HLS ``fixed<b, i>`` arithmetic, including the
cyclic wrap-around overflow of Eq. (1)/(2), on scaled integers held in
float64 (exact for b <= 52; the JAX package computes in float32 unless
x64 is on, which agrees for b <= 24).  When no overflow occurs, the proxy
output equals the quantized forward bit for bit.
"""
from __future__ import annotations

import torch

from .calibrate import FixedSpec
from .quantizer import _exp2i


def to_fixed(x, spec: FixedSpec, f, epsilon: float = 0.5) -> torch.Tensor:
    """Quantize to fixed<b, i> with Eq. (1)/(2) wrap-around; ``f`` is the
    fractional bitwidth.  Elementwise with broadcasting; returns float32
    values exactly on the fixed grid."""
    x64 = torch.as_tensor(x).to(torch.float64)
    dev = x64.device
    fi = torch.floor(torch.as_tensor(f, dtype=torch.float32, device=dev)
                     + 0.5)
    b = torch.as_tensor(spec.bits, device=dev).to(torch.float64)
    signed = torch.as_tensor(spec.signed, device=dev)
    # exact powers of two: an ulp-off exp2(b) makes the wrap modulus wrong
    # exactly at the +-2^(b-1) boundary (and at b = 13, 15, 26, ...)
    m = torch.floor(x64 * _exp2i(fi).to(torch.float64) + epsilon)
    two_b = _exp2i(b).to(torch.float64)
    half = _exp2i(b - 1.0).to(torch.float64)
    m_signed = torch.remainder(m + half, two_b) - half      # Eq. (1)
    m_unsigned = torch.remainder(m, two_b)                  # Eq. (2)
    m_wrapped = torch.where(signed, m_signed, m_unsigned)
    m_wrapped = torch.where(b > 0, m_wrapped, torch.zeros_like(m_wrapped))
    return (m_wrapped * _exp2i(-fi).to(torch.float64)).to(torch.float32)


def representable(x, spec: FixedSpec, f) -> torch.Tensor:
    """Elementwise: is x exactly representable (no wrap) in fixed<b, i>?"""
    x32 = torch.as_tensor(x, dtype=torch.float32)
    y = to_fixed(x32, spec, f)
    fi = torch.floor(torch.as_tensor(f, dtype=torch.float32,
                                     device=x32.device) + 0.5)
    return torch.abs(y - x32) < _exp2i(-fi - 1.0)
