"""HGQ fixed-point quantizer, forward half (counterpart of
``repro/core/quantizer.py``).

Eq. (4) of the paper, ``floor(x * 2^f + 1/2) * 2^-f``, plus the exact
power-of-two and log2 helpers every grid in the serving path shares.
The straight-through / surrogate-gradient training half waits for the
training slice.

Powers of two are built in the float32 exponent field and log2 is read
from ``frexp``: both are exact where ``exp2``/``log2`` approximations can
be an ulp off (2^13, 2^15, 2^26, ...), which would put grid points off
the fixed-point grid.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_NEG_LARGE = -127.0  # "no integer bits needed" sentinel (value is ~0)

_GRANULARITIES = ("per_tensor", "per_channel", "per_parameter")


def _exp2i(f: torch.Tensor) -> torch.Tensor:
    """Exact 2^f for integer-valued float f, clamped to float32's normal
    exponent range [-126, 127].  The float is clipped BEFORE the int cast
    (an out-of-range float->int conversion can wrap), then the biased
    exponent is shifted into place."""
    f = torch.as_tensor(f, dtype=torch.float32)
    biased = torch.clamp(f, -126.0, 127.0).to(torch.int32) + 127
    return torch.bitwise_left_shift(biased, 23).view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2 x) for x > 0 via frexp."""
    _, ex = torch.frexp(torch.as_tensor(x, dtype=torch.float32))
    return ex.to(torch.float32) - 1.0


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ceil(log2 x) for x > 0 via frexp."""
    man, ex = torch.frexp(torch.as_tensor(x, dtype=torch.float32))
    ex = ex.to(torch.float32)
    return torch.where(man == 0.5, ex - 1.0, ex)


def quantize_inference(x: torch.Tensor, f: torch.Tensor,
                       epsilon: float = 0.5) -> torch.Tensor:
    """Eq. (4) forward: ``floor(x * 2^fi + eps) / 2^fi``, fi = floor(f + .5),
    computed in float32 and cast back to x's dtype."""
    x32 = x.to(torch.float32)
    fi = torch.floor(torch.as_tensor(f, dtype=torch.float32,
                                     device=x.device) + 0.5)
    scale = _exp2i(fi)
    return (torch.floor(x32 * scale + epsilon) / scale).to(x.dtype)


def f_shape_for(shape: Sequence[int], granularity: str,
                channel_axis: int = -1) -> Tuple[int, ...]:
    """Shape of the fractional-bit tensor for a value of ``shape``:
    ``()`` per tensor, broadcastable along ``channel_axis`` per channel,
    ``shape`` per parameter."""
    if granularity not in _GRANULARITIES:
        raise ValueError(f"unknown granularity {granularity!r}")
    shape = tuple(shape)
    if granularity == "per_tensor" or not shape:
        return ()
    if granularity == "per_parameter":
        return shape
    ax = channel_axis % len(shape)
    return tuple(d if i == ax else 1 for i, d in enumerate(shape))


def group_size(value_shape: Sequence[int], f_sh: Sequence[int]) -> float:
    """Number of parameters sharing one bitwidth, ``||g||`` in the paper."""
    n_val = math.prod(value_shape) if value_shape else 1
    n_f = math.prod(f_sh) if f_sh else 1
    return float(n_val) / float(n_f)


def int_bits_from_range(vmin, vmax) -> torch.Tensor:
    """Eq. (3): integer bits (sign excluded) covering [vmin, vmax];
    zero-range values get the -127 sentinel so relu(i' + f) == 0."""
    vmin = torch.as_tensor(vmin, dtype=torch.float32)
    vmax = torch.as_tensor(vmax, dtype=torch.float32)
    neg = torch.full_like(vmax, _NEG_LARGE)
    hi = torch.where(vmax > 0,
                     floor_log2(torch.clamp(vmax, min=1e-30)) + 1.0, neg)
    lo = torch.where(vmin < 0, ceil_log2(torch.clamp(-vmin, min=1e-30)),
                     torch.full_like(vmin, _NEG_LARGE))
    return torch.maximum(hi, lo)


def train_bits(f: torch.Tensor, vmin, vmax,
               signed_bit: bool = True) -> torch.Tensor:
    """Bitwidth estimate ``max(i' + f, 0)`` that ~EBOPs counts; one more
    bit where the observed range goes negative (``signed_bit``)."""
    ip = int_bits_from_range(vmin, vmax)
    bits = torch.relu(ip + f)
    if signed_bit:
        neg = (torch.as_tensor(vmin) < 0).to(torch.float32)
        bits = bits + neg * (bits > 0).to(torch.float32)
    return bits
