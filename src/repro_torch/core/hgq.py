"""HGQ glue: quantized tensors, activation-range state, aux accumulation
(counterpart of ``repro/core/hgq.py``).

Quantized layers speak one protocol: weights carry a fractional-bit
tensor ``f`` beside the value; activations carry ``f`` plus a running
range state ``ActState(vmin, vmax)``; each multiplicative op adds its
~EBOPs term and each activation quantizer its L1 term to an :class:`Aux`.

Modes:
  TRAIN  -- quantize with surrogate gradients (``quantize``, the
            ``hgq_quantize`` kernel on the card), update ranges with
            slowly decaying running extremes.
  CALIB  -- exact range accumulation (no decay) for Eq.-3 calibration.
  EVAL   -- quantize, frozen ranges.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import ebops as ebops_lib
from .quantizer import (grad_scale, quantize, quantize_group,
                        quantize_inference, train_bits)

TRAIN, CALIB, EVAL = "train", "calib", "eval"

# decay of the running extremes in TRAIN mode: old extremes shrink toward
# zero slowly so stale outliers fade (approximates per-epoch min/max)
RANGE_DECAY = 0.999


class QTensor(NamedTuple):
    """A value plus its bitwidth estimate (None: unquantized, no EBOPs)."""
    q: torch.Tensor
    bits: Optional[torch.Tensor]


class ActState(NamedTuple):
    vmin: torch.Tensor
    vmax: torch.Tensor


@dataclasses.dataclass
class Aux:
    """Per-forward accumulator of ~EBOPs and the L1 bit term."""
    ebops: torch.Tensor
    l1: torch.Tensor

    @staticmethod
    def zero(device=None) -> "Aux":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return Aux(z, z.clone())

    def add(self, ebops=None, l1=None) -> None:
        if ebops is not None:
            self.ebops = self.ebops + ebops
        if l1 is not None:
            self.l1 = self.l1 + l1

    def merge(self, other: "Aux") -> None:
        self.ebops = self.ebops + other.ebops
        self.l1 = self.l1 + other.l1

    def as_tuple(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.ebops, self.l1)


def init_act_state(f_sh, device=None) -> ActState:
    return ActState(torch.zeros(f_sh, dtype=torch.float32, device=device),
                    torch.zeros(f_sh, dtype=torch.float32, device=device))


def _feature_extremes(x: torch.Tensor, f_sh) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Reduce x over batch/broadcast axes down to the f shape."""
    f_sh = tuple(f_sh)
    x32 = x.detach().to(torch.float32)
    nd = x32.ndim
    padded = (1,) * (nd - len(f_sh)) + f_sh
    axes = tuple(i for i in range(nd) if padded[i] == 1)
    if not axes:
        return x32.reshape(f_sh), x32.reshape(f_sh)
    vmin = torch.amin(x32, dim=axes, keepdim=True).reshape(f_sh)
    vmax = torch.amax(x32, dim=axes, keepdim=True).reshape(f_sh)
    return vmin, vmax


def observe(x: torch.Tensor, state: ActState, mode: str) -> ActState:
    """Update the running activation extremes: exact in CALIB, decaying
    by ``RANGE_DECAY`` in TRAIN, frozen in EVAL."""
    if mode == CALIB:
        vmin_b, vmax_b = _feature_extremes(x, state.vmin.shape)
        return ActState(torch.minimum(state.vmin, vmin_b),
                        torch.maximum(state.vmax, vmax_b))
    if mode == TRAIN:
        vmin_b, vmax_b = _feature_extremes(x, state.vmin.shape)
        return ActState(torch.minimum(state.vmin * RANGE_DECAY, vmin_b),
                        torch.maximum(state.vmax * RANGE_DECAY, vmax_b))
    return state


def _gsize(value_shape, f_sh) -> float:
    n_val = math.prod(value_shape) if value_shape else 1
    n_f = math.prod(f_sh) if f_sh else 1
    return max(float(n_val) / float(n_f), 1.0)


def _bits_f(f: torch.Tensor, value_shape, mode: str) -> torch.Tensor:
    """f as the bits estimate sees it: in TRAIN its gradient is scaled by
    1/sqrt(||g||) (SSec. III.D.3), on the bits path only, so the loss
    path's surrogate gradient through ``quantize`` is untouched."""
    if mode != TRAIN:
        return f
    return grad_scale(f, 1.0 / math.sqrt(_gsize(value_shape, f.shape)))


def _weight_bits(w: torch.Tensor, f: torch.Tensor, mode: str) -> torch.Tensor:
    vmin, vmax = _feature_extremes(w, f.shape)
    return train_bits(_bits_f(f, w.shape, mode), vmin, vmax, signed_bit=False)


def quant_weight(w: torch.Tensor, f: Optional[torch.Tensor],
                 mode: str = TRAIN) -> QTensor:
    """Quantize a weight on its 2^-f grid; bits from Eq. 3 on the
    per-group weight extremes (no sign bit: constants)."""
    if f is None:
        return QTensor(w, None)
    wq = quantize(w, f) if mode == TRAIN else quantize_inference(w, f)
    return QTensor(wq, _weight_bits(w, f, mode))


def quant_weights(ws: Sequence[torch.Tensor],
                  fs: Sequence[Optional[torch.Tensor]],
                  mode: str = TRAIN) -> List[QTensor]:
    """:func:`quant_weight` of each (w, f) pair, the same values, bits and
    gradients; in TRAIN the quantizers of every pair with an f run as one
    group (``quantize_group``: one kernel launch on the card)."""
    if mode != TRAIN:
        return [quant_weight(w, f, mode) for w, f in zip(ws, fs)]
    idx = [i for i, f in enumerate(fs) if f is not None]
    wqs = quantize_group([ws[i] for i in idx], [fs[i] for i in idx])
    out = [QTensor(w, None) for w in ws]
    for i, wq in zip(idx, wqs):
        out[i] = QTensor(wq, _weight_bits(ws[i], fs[i], mode))
    return out


def quant_act(x: torch.Tensor, f: Optional[torch.Tensor],
              state: Optional[ActState], mode: str, aux: Optional[Aux],
              gamma_l1: bool = True) -> Tuple[QTensor, Optional[ActState]]:
    """Quantize an activation; update its range state.  With ``aux`` set,
    also compute the bits estimate and add the L1 term; ``aux=None``
    skips that bookkeeping (a decode step whose Aux nobody reads)."""
    if f is None:
        return QTensor(x, None), state
    xq = quantize(x, f) if mode == TRAIN else quantize_inference(x, f)
    new_state = observe(x, state, mode) if state is not None else None
    if aux is None:
        return QTensor(xq, None), new_state
    if new_state is not None:
        bits = train_bits(_bits_f(f, x.shape, mode), new_state.vmin,
                          new_state.vmax, signed_bit=True)
    else:
        bits = torch.relu(f) + 1.0
    if gamma_l1:
        aux.add(l1=ebops_lib.l1_bits(torch.relu(f)))
    return QTensor(xq, bits), new_state


def matmul_ebops(aux: Optional[Aux], x_bits, w_bits, in_dim: int,
                 out_dim: int) -> None:
    """Record ~EBOPs of a dense matmul if both operands are quantized."""
    if aux is None or x_bits is None or w_bits is None:
        return
    aux.add(ebops=ebops_lib.ebops_matmul(x_bits, w_bits, in_dim, out_dim))


def dyn_matmul_ebops(aux: Optional[Aux], a_bits, b_bits, a_shape,
                     b_shape) -> None:
    """Record ~EBOPs of a variable x variable matmul if both operands are
    quantized."""
    if aux is None or a_bits is None or b_bits is None:
        return
    aux.add(ebops=ebops_lib.ebops_dyn_matmul(a_bits, b_bits, a_shape,
                                             b_shape))
