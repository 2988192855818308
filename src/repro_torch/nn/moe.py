"""Quantized Mixture-of-Experts block, top-k routing over GLU experts
(counterpart of ``repro/nn/moe.py``).

The reference dispatches per batch row (a vmap over B): each row sorts
its own S * k (token, expert) pairs by expert and packs them into a fixed
``[E, C, d]`` buffer; a pair past its expert's capacity C is dropped.
Here the same dispatch runs batched over B:

* **Routing.** The first k of a *stable* descending sort of the float32
  probabilities (``jax.lax.top_k`` puts the lower expert first on ties,
  which ``torch.topk`` does not promise), renormalized over the k.
* **Dispatch.** A stable argsort of each row's flat expert ids, the
  counts an integer scatter of ones, ``pos = rank - starts[e]`` and
  ``valid = pos < C``.  The ``[B, E, C, d]`` buffer is *gathered*: slot
  ``(e, c)`` reads the token of sorted pair ``starts[e] + c`` where
  ``c < counts[e]`` and holds +0.0 elsewhere, so no scatter (and no
  write order) is involved.  Its backward (``_DispatchGather``) is the
  reference's: the gradient of ``xr[st_]`` scatter-adds the sorted
  pairs' slot gradients into zeros in sorted order, i.e. each token's k
  in ascending expert order, a dropped pair (the dump slot) as +0.0;
  here they are gathered in that order and added one after another from
  +0.0 (no accumulating ``index_put``, whose atomics add in no fixed
  order on the card).
* **Expert products** run on the dequantized stacks (``get_qw``) as plain
  float32 batched matmuls, ``[E, B * C, d] @ [E, d, f]``; a row's result
  depends on the batch's shape only, not on its other rows.
* **Combine.** The reference adds each token's k contributions into
  zeros with a scatter-add that applies them in the sorted order, i.e.
  in ascending expert order, a dropped pair as +0.0.  Here each token's
  contributions are gathered in ascending expert order and summed one
  after another from +0.0: the same additions in the same order (no
  ``index_add_``, whose atomics add in no fixed order on the card).

The expert hidden activation is quantized per tensor over the whole
``[B, E, C, dff]`` buffer, empty slots included, as the reference does.
~EBOPs count active compute only (``top_k / E`` of each expert's
multipliers) and only where an ``Aux`` is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.hgq import Aux, QTensor
from .basic import HDense, activation
from .common import HGQConfig, act_q_init, apply_act_q, get_qw, uniform_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int            # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"


def _expert_weight(gen: torch.Generator, e: int, din: int, dout: int,
                   cfg: HGQConfig, device=None) -> Dict[str, Any]:
    p = {"w": uniform_init(gen, (e, din, dout), device=device)}
    if cfg.enabled:
        if cfg.weight_gran == "per_parameter":
            f_sh = (e, din, dout)
        elif cfg.weight_gran == "per_channel":
            f_sh = (e, 1, dout)            # per-expert, per-out-channel
        else:
            f_sh = (e, 1, 1)               # per-expert tensor
        p["f"] = torch.full(f_sh, cfg.init_weight_f, dtype=torch.float32,
                            device=device)
    return p


def capacity(S: int, cfg: MoEConfig) -> int:
    """Slots per expert for a row of S tokens, computed in Python floats
    as the reference computes it."""
    return max(1, math.ceil(S * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))


def renormalize(gates: torch.Tensor) -> torch.Tensor:
    """The top-k probabilities rescaled to sum to 1."""
    return gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)


def route(logits: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert ids), each ``[..., k]``, highest probability first;
    equal probabilities keep the lower expert first."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return renormalize(srt.values[..., :top_k]), srt.indices[..., :top_k]


@dataclasses.dataclass
class Dispatch:
    """One batch's dispatch: each pair's place (in the pairs' own
    ``[B, S, k]`` order) and each slot's token."""
    pos: torch.Tensor        # [B, S, k] rank of the pair in its expert
    valid: torch.Tensor      # [B, S, k] pos < C: the pair is kept
    slot_token: torch.Tensor  # [B, E, C] the token a slot holds
    filled: torch.Tensor     # [B, E, C] the slot holds a kept pair


def dispatch(eidx: torch.Tensor, n_experts: int, C: int) -> Dispatch:
    """The reference's per-row dispatch of ``eidx [B, S, k]``, batched."""
    B, S, k = eidx.shape
    E, Tk, dev = n_experts, S * k, eidx.device
    e_flat = eidx.reshape(B, Tk)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_sorted = torch.arange(Tk, device=dev) - torch.gather(starts, 1, se)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    c = torch.arange(C, device=dev)
    filled = c < counts[:, :, None]
    first = torch.clamp(starts[:, :, None] + c, max=Tk - 1)
    slot_token = torch.gather(order, 1, first.reshape(B, E * C)) // k
    pos = pos.reshape(B, S, k)
    return Dispatch(pos=pos, valid=pos < C,
                    slot_token=slot_token.reshape(B, E, C), filled=filled)


@dataclasses.dataclass
class TokenSlots:
    """Each token's k pairs in ascending expert order (``[B, S, k]``):
    the permutation of its ``eidx`` entries, the slot each reads in the
    ``[E * B * C]`` rows of the buffer (``(e * B + b) * C + pos``, a
    dropped pair's clamped to ``C - 1``), and whether it was kept."""
    perm: torch.Tensor
    rows: torch.Tensor
    valid: torch.Tensor


def token_slots(eidx: torch.Tensor, dsp: Dispatch, C: int) -> TokenSlots:
    B = eidx.shape[0]
    e_up, perm = torch.sort(eidx, dim=-1)
    pos_up = torch.gather(dsp.pos, -1, perm)
    rows = (e_up * B + torch.arange(B, device=eidx.device)[:, None, None]) \
        * C + torch.clamp(pos_up, max=C - 1)
    return TokenSlots(perm=perm, rows=rows,
                      valid=torch.gather(dsp.valid, -1, perm))


def _add_in_order(contrib: torch.Tensor) -> torch.Tensor:
    """``[B, S, k, d]`` -> ``[B, S, d]``: the k terms added to +0.0 one
    after another, in order."""
    B, S, k, d = contrib.shape
    y = torch.zeros((B, S, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


class _DispatchGather(torch.autograd.Function):
    """The expert buffer ``[E, B * C, d]`` from ``x [B, S, d]``: slot
    ``(e, b * C + c)`` holds row b's token ``tok`` where ``filled``, +0.0
    elsewhere.  Backward: each token's k slot gradients gathered in
    ascending expert order (``slots``), a dropped pair reading an
    appended zero row, and added one after another from +0.0 -- the
    reference's scatter-add order (``xr[st_]`` in sorted-pair order)."""

    @staticmethod
    def forward(ctx, x, tok, filled, slots):
        B, S, d = x.shape
        ctx.save_for_backward(slots)
        return torch.where(filled, x.reshape(B * S, d)[tok], 0.0)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        E, BC, d = g.shape
        padded = torch.cat([g.reshape(E * BC, d), g.new_zeros((1, d))])
        return _add_in_order(padded[slots]), None, None, None


def _combine(y_e: torch.Tensor, gates: torch.Tensor, ts: TokenSlots
             ) -> torch.Tensor:
    """``y_e [E, B, C, d]`` -> ``[B, S, d]``: each token's k gated
    contributions added to +0.0 one after another in ascending expert
    order, a dropped pair as +0.0.

    The gather's own backward (an accumulating ``index_put``) is exact in
    any order: kept pairs read distinct slots, and a dropped pair, which
    may read a kept pair's clamped slot again, brings an exact zero (its
    ``where`` gradient times a gate >= 0) into a zero-initialized sum,
    where adding zeros changes no bits."""
    E, B, C, d = y_e.shape
    S, k = ts.rows.shape[1], ts.rows.shape[2]
    g_up = torch.gather(gates, -1, ts.perm)
    contrib = torch.where(ts.valid[..., None],
                          y_e.reshape(E * B * C, d)[ts.rows.reshape(-1)]
                          .reshape(B, S, k, d) * g_up[..., None], 0.0)
    return _add_in_order(contrib.to(torch.float32))


def _wsum(bits: torch.Tensor, full_shape) -> torch.Tensor:
    return torch.sum(bits) * (math.prod(full_shape) / math.prod(bits.shape))


class MoE:
    @staticmethod
    def init(gen: torch.Generator, cfg: MoEConfig, qcfg: HGQConfig,
             device=None):
        d, dff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["router"], q["router"] = HDense.init(gen, d, E, qcfg, bias=False,
                                               out_q=False, device=device)
        p["gate"] = _expert_weight(gen, E, d, dff, qcfg, device)
        p["up"] = _expert_weight(gen, E, d, dff, qcfg, device)
        p["down"] = _expert_weight(gen, E, dff, d, qcfg, device)
        if qcfg.enabled:
            f, st = act_q_init(qcfg, device=device)
            p["h_f"] = f
            q["h"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, cfg: MoEConfig, mode: str,
              aux: Optional[Aux],
              weights: Optional[Dict[str, Any]] = None
              ) -> Tuple[QTensor, Dict[str, Any]]:
        """``weights``: the router's quantized kernel (``{"kernel":
        QTensor}``, ``HDense.apply``'s ``wq``) and the ``gate``, ``up``
        and ``down`` stacks' (QTensors), made beforehand (the layer's one
        grouped launch in TRAIN); without it they are quantized here."""
        B, S, d = x.q.shape
        E, k, dff = cfg.n_experts, cfg.top_k, cfg.d_ff
        w = weights or {}
        newq: Dict[str, Any] = {}
        logits, newq["router"] = HDense.apply(p["router"], q["router"], x,
                                              mode=mode, aux=aux,
                                              wq=w.get("router"))
        gates, eidx = route(logits.q, k)                 # [B, S, k]
        wg, wu, wd = (w[n] if n in w else get_qw(p[n], mode)
                      for n in ("gate", "up", "down"))
        C = capacity(S, cfg)
        dsp = dispatch(eidx, E, C)
        ts = token_slots(eidx, dsp, C)

        # [E, B * C, d]: slot (e, c) of row b holds its token's x, or +0.0
        tok = (dsp.slot_token + S * torch.arange(B, device=x.q.device)
               [:, None, None]).permute(1, 0, 2).reshape(E, B * C)
        filled = dsp.filled.permute(1, 0, 2).reshape(E, B * C, 1)
        xe = _DispatchGather.apply(
            x.q, tok, filled,
            torch.where(ts.valid, ts.rows, E * B * C))
        g_h = torch.bmm(xe, wg.q)
        u_h = torch.bmm(xe, wu.q)
        h = (activation(cfg.act, g_h) * u_h).to(x.q.dtype)
        # the expert hidden activation, quantized per tensor
        if p.get("h_f") is not None:
            hq, newq["h"] = apply_act_q(h, p["h_f"], q.get("h"), mode, aux)
            h, h_bits = hq.q, hq.bits
        else:
            h_bits = None
        y_e = torch.bmm(h, wd.q).reshape(E, B, C, d)
        y = _combine(y_e, gates, ts).to(x.q.dtype)

        # ---- active-compute ~EBOPs (analytic, scaled by k/E) ----
        if aux is not None and x.bits is not None and wg.bits is not None:
            frac = float(k) / float(E)
            e_in = torch.max(x.bits) * (_wsum(wg.bits, (E, d, dff))
                                        + _wsum(wu.bits, (E, d, dff)))
            aux.add(ebops=frac * e_in)
            if h_bits is not None and wd.bits is not None:
                aux.add(ebops=frac * torch.max(h_bits)
                        * _wsum(wd.bits, (E, dff, d)))
        return QTensor(y, None), newq
