"""HGQ fixed-point quantizer with gradient-trainable fractional bitwidths
(counterpart of ``repro/core/quantizer.py``).

Eq. (4) of the paper, ``floor(x * 2^f + 1/2) * 2^-f``; in training the
Algorithm-1 gradients, straight-through in x and ``+ln2 * delta`` in f
(Eq. 15), through the ``hgq_quantize`` kernel; the exact power-of-two
and log2 helpers every grid shares; and the exact occupied-bit counts of
EBOPs (SSec. III.C).

Powers of two are built in the float32 exponent field and log2 is read
from ``frexp``: both are exact where ``exp2``/``log2`` approximations can
be an ulp off (2^13, 2^15, 2^26, ...), which would put grid points off
the fixed-point grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

LN2 = 0.6931471805599453

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


def ste_round(x: torch.Tensor, epsilon: float = 0.5) -> torch.Tensor:
    """``floor(x + eps)`` with a straight-through gradient (QKeras
    convention; midpoint rounds up at eps = 1/2)."""
    return x + (torch.floor(x + epsilon) - x).detach()


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity in the forward pass; multiplies the gradient by ``scale``
    (the 1/sqrt(||g||) normalization of the regularizer gradient on shared
    bitwidths, paper SSec. III.D.3)."""
    return _GradScale.apply(x, scale)


def quantize(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """HGQ Algorithm-1 quantizer, differentiable in x (straight-through)
    and f (``+ln2 * (x - xq)``, the gradient through ``ste_round(f)``).

    The forward is Eq. 4 on the exact grid, ``quantize_inference``'s
    values, computed by the ``hgq_quantize`` kernel on the card.  (The JAX
    package's ``quantize`` returns ``x - (sg(d + a) - a)``, which float32
    leaves up to an ulp off the grid; its kernel op, like this one, lands
    on it.)"""
    from ..kernels.hgq_quantize.ops import hgq_quantize
    return hgq_quantize(x, f)


def quantize_group(xs: Sequence[torch.Tensor],
                   fs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`quantize` of each (x, f) pair, the same values and gradients;
    on the card the forwards are one ``hgq_quantize`` launch."""
    from ..kernels.hgq_quantize.ops import hgq_quantize_group
    return hgq_quantize_group(xs, fs)


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


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static configuration of one HGQ quantizer."""
    granularity: str = "per_parameter"
    init_frac_bits: float = 2.0
    channel_axis: int = -1
    trainable: bool = True
    # extra margin (in powers of two) added during calibration for outliers
    calib_margin_bits: float = 0.0

    def init_f(self, value_shape: Sequence[int], device=None) -> torch.Tensor:
        return torch.full(f_shape_for(value_shape, self.granularity,
                                      self.channel_axis),
                          self.init_frac_bits, dtype=torch.float32,
                          device=device)


# ---------------------------------------------------------------------------
# Exact occupied-bit counting (EBOPs, SSec. III.C) -- post-training, on
# quantized constants: the bits enclosed by the most and least significant
# non-zero bits (001xx1000 counts 4).
# ---------------------------------------------------------------------------

def _mantissa24(m_float: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 24-bit integer mantissa of a non-negative float32:
    ``(m24, ex)`` with ``m_float == m24 * 2^(ex - 24)``, ``m24`` an int32
    in [2^23, 2^24) (0 for 0), from ``frexp``, so no magnitude overflows."""
    man, ex = torch.frexp(torch.as_tensor(m_float, dtype=torch.float32))
    m24 = torch.round(man * float(2 ** 24)).to(torch.int32)
    return m24, ex.to(torch.float32)


def _trailing_zeros(m: torch.Tensor) -> torch.Tensor:
    """Trailing zero count of a non-negative int32 (0 -> 0), frexp-exact."""
    m = m.to(torch.int64)
    lowbit = torch.bitwise_and(m, -m)          # the lowest set bit
    _, ex = torch.frexp(lowbit.to(torch.float32))
    return torch.where(m > 0, ex.to(torch.float32) - 1.0,
                       torch.zeros((), dtype=torch.float32, device=m.device))


def _f_effective(fi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cap fi so |w| * 2^fi stays < 2^25: past float32's 24 mantissa bits
    rounding is the identity and the occupied span is shift-invariant, so
    the cap never changes a count, while an uncapped fi can overflow."""
    _, ex_w = torch.frexp(torch.abs(torch.as_tensor(w, dtype=torch.float32)))
    return torch.minimum(fi, 25.0 - ex_w.to(torch.float32))


def occupied_bits(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Exact per-element occupied bits of quantized constants ``w``:
    with |w_q| = m * 2^-f, floor(log2 m) - trailing_zeros(m) + 1, 0 for
    m = 0; on the normalized mantissa, ``24 - trailing_zeros(m24)``."""
    w32 = torch.as_tensor(w, dtype=torch.float32)
    fi = torch.floor(torch.as_tensor(f, dtype=torch.float32,
                                     device=w32.device) + 0.5)
    mf = torch.abs(torch.round(w32 * _exp2i(_f_effective(fi, w32))))
    m24, _ = _mantissa24(mf)
    return torch.where(m24 > 0, 24.0 - _trailing_zeros(m24),
                       torch.zeros((), dtype=torch.float32,
                                   device=w32.device))


def _reduce_axes(value_shape: Sequence[int], f_sh: Sequence[int]
                 ) -> Tuple[int, ...]:
    value_shape, f_sh = tuple(value_shape), tuple(f_sh)
    if not f_sh:
        return tuple(range(len(value_shape)))
    if len(f_sh) != len(value_shape):
        raise ValueError(f"f shape {f_sh} vs value shape {value_shape}")
    return tuple(i for i, (v, g) in enumerate(zip(value_shape, f_sh))
                 if g == 1 and v != 1)


def group_occupied_bits(w: torch.Tensor, f: torch.Tensor,
                        f_sh: Sequence[int]) -> torch.Tensor:
    """Occupied bits when a group of weights shares one multiplier: the
    span from the group's most- to its least-significant non-zero bit
    (SSec. III.C), over the axes where f is broadcast."""
    w32 = torch.as_tensor(w, dtype=torch.float32)
    f = torch.broadcast_to(torch.as_tensor(f, dtype=torch.float32,
                                           device=w32.device), w32.shape)
    fi = _f_effective(torch.floor(f + 0.5), w32)
    mf = torch.abs(torch.round(w32 * _exp2i(fi)))
    m24, ex = _mantissa24(mf)
    # msb index of mf is ex-1; its trailing zeros are tz(m24) - (24 - ex);
    # rebasing by the same (effective) fi keeps positions absolute
    nz = m24 > 0
    msb = torch.where(nz, (ex - 1.0) - fi, torch.full_like(fi, _NEG_LARGE))
    lsb = torch.where(nz, (_trailing_zeros(m24) + ex - 24.0) - fi,
                      torch.full_like(fi, -_NEG_LARGE))
    axes = _reduce_axes(w32.shape, f_sh)
    if axes:
        msb = torch.amax(msb, dim=axes, keepdim=True)
        lsb = torch.amin(lsb, dim=axes, keepdim=True)
    bits = msb - lsb + 1.0
    return torch.where(msb >= lsb, bits, torch.zeros_like(bits)).reshape(
        tuple(f_sh))
