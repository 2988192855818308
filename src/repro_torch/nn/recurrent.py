"""The RG-LRU recurrent block of Griffin / RecurrentGemma (counterpart of
the RG-LRU half of ``repro/nn/recurrent.py``).

The RWKV-6 half of the reference module (``RWKVTimeMix``,
``RWKVChannelMix``, ``_wkv_chunked``, ``_wkv_sequential``) is not ported
yet: it is the next family's slice.

What keeps the bits of the reference:

* ``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)``, i.e.
  ``max(x, 0) + log1p(exp(-|x|))`` (``torch.nn.functional.softplus`` is
  ``log1p(exp(x))`` with a threshold, another function at the ulp).
* The causal depthwise conv is a Python ``sum`` from 0 over the taps in
  order, as the reference writes it.
* :func:`_linear_scan` is ``lax.associative_scan``'s pairwise recursion
  (combine adjacent pairs, scan the half, fix up the even elements,
  interleave), not a left-to-right loop: the two add in different orders,
  and over a prefill chunk of 16 a loop is ulps away, which activation
  quantizer ties can amplify.  It is log-depth on the card as on the TPU.

The reference's sharding constraints (``dist.axes.constrain``) are left
out: the port has no model axis.  A packed ``conv_w`` (rank 2, so the
serving packer packs it, in nibbles along the 4 taps under a 4-bit plan)
is read through ``get_qw``'s dequantization, as the reference reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.hgq import Aux, QTensor
from .basic import HDense
from .common import HGQConfig, get_qw, qweight_init


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4
    c_const: float = 8.0


class GriffinState(NamedTuple):
    conv: torch.Tensor   # [B, conv_width-1, d_rnn]
    h: torch.Tensor      # [B, d_rnn]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as the reference computes
    it (a NaN passes through)."""
    return torch.where(torch.isnan(x), x, torch.clamp(x, min=0.0)
                       + torch.log1p(torch.exp(-torch.abs(x))))


def input_norm(log_a: torch.Tensor) -> torch.Tensor:
    """The RG-LRU's input normalization ``sqrt(1 - a^2)``, a = exp(log_a)
    (a module function: the card's Griffin controls patch it)."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))


def conv_history(state: Optional[GriffinState], x: torch.Tensor,
                 cw: int) -> torch.Tensor:
    """The conv's ``cw - 1`` inputs before x [B, S, d_rnn]: the carried
    state's, zeros without one (a module function: the card's Griffin
    controls patch it)."""
    if state is None:
        return torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    return state.conv.to(x.dtype)


class RecurrentBlock:
    """Griffin recurrent block: (gelu branch) * (conv -> RG-LRU branch)."""

    @staticmethod
    def init(gen, cfg: RGLRUConfig, qcfg: HGQConfig, device=None):
        d, dr = cfg.d_model, cfg.d_rnn
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["in_gelu"], q["in_gelu"] = HDense.init(gen, d, dr, qcfg, bias=False,
                                                 device=device)
        p["in_rnn"], q["in_rnn"] = HDense.init(gen, d, dr, qcfg, bias=False,
                                               device=device)
        p["conv_w"] = qweight_init(gen, (cfg.conv_width, dr), qcfg,
                                   device=device)
        p["gate_a"], q["gate_a"] = HDense.init(gen, dr, dr, qcfg, bias=True,
                                               device=device)
        p["gate_x"], q["gate_x"] = HDense.init(gen, dr, dr, qcfg, bias=True,
                                               device=device)
        p["lambda"] = torch.full((dr,), 2.2, dtype=torch.float32,
                                 device=device)            # sigmoid ~ 0.9
        p["out"], q["out"] = HDense.init(gen, dr, d, qcfg, bias=False,
                                         out_q=False, device=device)
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, state: Optional[GriffinState], *,
              cfg: RGLRUConfig, mode: str, aux: Optional[Aux]
              ) -> Tuple[QTensor, Dict[str, Any], GriffinState]:
        """x [B, S, d] -> (out [B, S, d], new range states, the state after
        the last position).  ``state`` None starts from zeros."""
        B, S, _ = x.q.shape
        dr, cw = cfg.d_rnn, cfg.conv_width
        newq: Dict[str, Any] = {}
        gelu_b, newq["in_gelu"] = HDense.apply(p["in_gelu"], q["in_gelu"], x,
                                               mode=mode, aux=aux, act="gelu")
        rnn_b, newq["in_rnn"] = HDense.apply(p["in_rnn"], q["in_rnn"], x,
                                             mode=mode, aux=aux)
        # causal depthwise conv1d (width cw), the taps summed from 0 in order
        xc = torch.cat([conv_history(state, rnn_b.q, cw), rnn_b.q], dim=1)
        wq = get_qw(p["conv_w"], mode)
        u = sum(xc[:, i:i + S] * wq.q[i] for i in range(cw))
        if aux is not None and rnn_b.bits is not None \
                and wq.bits is not None:
            aux.add(ebops=torch.max(rnn_b.bits) * torch.sum(
                torch.broadcast_to(wq.bits, (cw, dr))))
        uq = QTensor(u, rnn_b.bits)
        # RG-LRU gates
        ra, newq["gate_a"] = HDense.apply(p["gate_a"], q["gate_a"], uq,
                                          mode=mode, aux=aux)
        rx, newq["gate_x"] = HDense.apply(p["gate_x"], q["gate_x"], uq,
                                          mode=mode, aux=aux)
        r_a = torch.sigmoid(ra.q.to(torch.float32))
        i_x = torch.sigmoid(rx.q.to(torch.float32))
        log_a0 = -cfg.c_const * softplus(p["lambda"]).to(torch.float32)
        log_a = log_a0 * r_a                              # [B, S, dr], <= 0
        a = torch.exp(log_a)
        gated = input_norm(log_a) * i_x * u.to(torch.float32)
        h0 = state.h if state is not None else torch.zeros(
            (B, dr), dtype=torch.float32, device=u.device)
        h = _linear_scan(a, gated, h0)
        y = (gelu_b.q.to(torch.float32) * h).to(x.q.dtype)
        out, newq["out"] = HDense.apply(p["out"], q["out"],
                                        QTensor(y, gelu_b.bits), mode=mode,
                                        aux=aux)
        return out, newq, GriffinState(conv=xc[:, -(cw - 1):], h=h[:, -1])


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, b1 * a2 + b2


def _scan(a: torch.Tensor, b: torch.Tensor):
    """``lax.associative_scan(_combine, (a, b), axis=1)``, its recursion
    step for step."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                             (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, even, odd in ((a[:, :1], ea, oa), (b[:, :1], eb, ob)):
        t = torch.empty_like(first.expand((-1, n) + tuple(first.shape[2:])))
        t[:, 0::2] = torch.cat([first, even], dim=1)
        t[:, 1::2] = odd
        out.append(t)
    return out[0], out[1]


def _linear_scan(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1, by the reference's
    associative scan (see the module docstring)."""
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    return _scan(a, b)[1]
