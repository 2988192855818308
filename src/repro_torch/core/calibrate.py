"""Post-training calibration (paper SSec. III.A, Eq. 3; counterpart of
``repro/core/calibrate.py``).

After QAT, integer bitwidths are fixed by running a calibration set
through the network in CALIB mode (exact running extremes), then

    i' = max( floor(log2 |vmax_q|) + 1,  ceil(log2 |vmin_q|) )
    i  = i' + 1  (signed)   |   i' (unsigned)

optionally padding the range by ``margin_bits`` powers of two.  The
result is a :class:`FixedSpec` per quantizer, consumed by the bit-exact
fixed-point emulation (``core.fixedpoint``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .hgq import ActState, _feature_extremes
from .quantizer import _exp2i, ceil_log2, floor_log2, quantize_inference


class FixedSpec(NamedTuple):
    """A fixed-point type fixed<b, i> (AMD HLS convention: the sign bit,
    when present, is part of the integer bits)."""
    bits: torch.Tensor      # total bitwidth b (0: pruned / constant 0)
    int_bits: torch.Tensor  # integer bits i (incl. the sign bit if signed)
    signed: torch.Tensor    # bool


def _f32(v, like=None) -> torch.Tensor:
    dev = None if like is None else like.device
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def int_bits_exact(vmin, vmax, f, margin_bits: float = 0.0) -> torch.Tensor:
    """Eq. (3) on the *quantized* extremes, with frexp-exact log2 (an
    ulp-low log2 at 2^13 would allocate one integer bit too few)."""
    vmin, vmax = _f32(vmin), _f32(vmax)
    fi = torch.floor(_f32(f, vmin) + 0.5)
    vmin_q = quantize_inference(vmin, fi)
    vmax_q = quantize_inference(vmax, fi)
    if margin_bits:
        vmin_q = vmin_q * (2.0 ** margin_bits)
        vmax_q = vmax_q * (2.0 ** margin_bits)
    none = torch.full_like(vmax_q, -127.0)
    hi = torch.where(vmax_q > 0,
                     floor_log2(torch.clamp(torch.abs(vmax_q),
                                            min=2.0 ** -126)) + 1.0, none)
    lo = torch.where(vmin_q < 0,
                     ceil_log2(torch.clamp(torch.abs(vmin_q),
                                           min=2.0 ** -126)), none)
    return torch.maximum(hi, lo)


def fixed_spec_from_range(state: ActState, f,
                          margin_bits: float = 0.0) -> FixedSpec:
    """The deployable fixed-point type of one quantizer."""
    vmin, vmax = _f32(state.vmin), _f32(state.vmax)
    fi = torch.floor(_f32(f, vmin) + 0.5)
    ip = int_bits_exact(vmin, vmax, fi, margin_bits)
    signed = vmin < 0
    i = torch.where(signed, ip + 1.0, ip)
    b = torch.clamp(i + fi, min=0.0)
    # a value whose range collapsed to {0} needs no bits at all
    dead = (vmax <= 0) & (vmin >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=vmin.device)
    return FixedSpec(bits=torch.where(dead, zero, b),
                     int_bits=torch.where(dead, zero, i), signed=signed)


def fixed_spec_for_weights(w: torch.Tensor, f: torch.Tensor,
                           f_sh=None) -> FixedSpec:
    """Weights are constants: their range is known exactly."""
    vmin, vmax = _feature_extremes(w, f.shape if f_sh is None else f_sh)
    return fixed_spec_from_range(ActState(vmin, vmax), f)


def assert_no_overflow(x: torch.Tensor, spec: FixedSpec, f) -> torch.Tensor:
    """True iff every element of x (quantized at f) is representable by
    ``spec`` -- the calibration guarantee on its own data."""
    x = _f32(x)
    fi = torch.floor(_f32(f, x) + 0.5)
    xq = quantize_inference(x, fi)
    bits, ib = _f32(spec.bits, x), _f32(spec.int_bits, x)
    signed = torch.as_tensor(spec.signed, device=x.device)
    top = _exp2i(ib - signed.to(torch.float32)) - _exp2i(-fi)
    bot = torch.where(signed, -_exp2i(ib - 1.0),
                      torch.zeros((), dtype=torch.float32, device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    top = torch.where(bits > 0, top, zero)
    bot = torch.where(bits > 0, bot, zero)
    return torch.all((xq <= top + 1e-9) & (xq >= bot - 1e-9))
