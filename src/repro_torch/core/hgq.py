"""HGQ glue, forward half (counterpart of ``repro/core/hgq.py``).

Quantized layers speak one protocol: weights carry a fractional-bit
tensor ``f`` beside the value; activations carry ``f`` plus a running
range state ``ActState(vmin, vmax)``; each multiplicative op adds its
~EBOPs term and each activation quantizer its L1 term to an :class:`Aux`.

Modes: CALIB accumulates exact ranges, EVAL freezes them.  TRAIN (the
surrogate-gradient quantizer and decaying ranges) waits for the training
slice and raises here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import ebops as ebops_lib
from .quantizer import quantize_inference, train_bits

TRAIN, CALIB, EVAL = "train", "calib", "eval"


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


def _forward_only(mode: str) -> None:
    if mode == TRAIN:
        raise NotImplementedError(
            "TRAIN mode (surrogate-gradient quantizer) is not ported yet; "
            "serving runs in EVAL")


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
    """Update the running activation extremes (exact in CALIB, frozen in
    EVAL)."""
    _forward_only(mode)
    if mode == CALIB:
        vmin_b, vmax_b = _feature_extremes(x, state.vmin.shape)
        return ActState(torch.minimum(state.vmin, vmin_b),
                        torch.maximum(state.vmax, vmax_b))
    return state


def _gsize(value_shape, f_sh) -> float:
    n_val = math.prod(value_shape) if value_shape else 1
    n_f = math.prod(f_sh) if f_sh else 1
    return max(float(n_val) / float(n_f), 1.0)


def quant_weight(w: torch.Tensor, f: Optional[torch.Tensor],
                 mode: str = EVAL) -> QTensor:
    """Quantize a weight on its 2^-f grid; bits from Eq. 3 on the
    per-group weight extremes (no sign bit: constants)."""
    _forward_only(mode)
    if f is None:
        return QTensor(w, None)
    wq = quantize_inference(w, f)
    vmin, vmax = _feature_extremes(w, f.shape)
    return QTensor(wq, train_bits(f, vmin, vmax, signed_bit=False))


def quant_act(x: torch.Tensor, f: Optional[torch.Tensor],
              state: Optional[ActState], mode: str, aux: Optional[Aux],
              gamma_l1: bool = True) -> Tuple[QTensor, Optional[ActState]]:
    """Quantize an activation; update its range state.  With ``aux`` set,
    also compute the bits estimate and add the L1 term; ``aux=None``
    skips that bookkeeping (a decode step whose Aux nobody reads)."""
    _forward_only(mode)
    if f is None:
        return QTensor(x, None), state
    xq = quantize_inference(x, f)
    new_state = observe(x, state, mode) if state is not None else None
    if aux is None:
        return QTensor(xq, None), new_state
    if new_state is not None:
        bits = train_bits(f, new_state.vmin, new_state.vmax, signed_bit=True)
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
