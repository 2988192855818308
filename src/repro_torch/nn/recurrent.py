"""Attention-free sequence mixers: RWKV-6 (Finch) and the RG-LRU block of
Griffin / RecurrentGemma (counterpart of ``repro/nn/recurrent.py``).

What keeps the bits of the reference, RWKV-6:

* :func:`_wkv_chunked` runs the reference's chunked form on every S, a
  decode tick's S = 1 included: ``logw = log(max(w, 1e-38))``, the
  exclusive prefix ``pre``, ``exp(min(-cum, 60))``, the strictly lower
  mask, ``y = y_state + A v + bonus v`` added in that order, and the
  state updated by ``exp(tot) S + (k exp(tot - cum)) v^T``.  The step
  ``w S + k v^T`` of :func:`_wkv_sequential` is another function at the
  ulp (``exp(log(w))`` is not ``w``), which activation quantizer ties
  can amplify.
* The chunk's cumulative sum of ``logw`` is taken left to right
  (:func:`_cumsum`): XLA's ``cumsum`` on the CPU gives those bits up to
  17 positions, and a prefill chunk is at most 16 (``torch.cumsum`` gives
  neither).
* ``jax.nn.silu`` is ``x * sigmoid(x)`` (``F.silu`` is another function
  at the ulp).
* The sums over a head's 64 channels (the WKV contractions, the per-head
  norm) and the decay LoRA's two matmuls are summed in float64 and
  rounded once to float32 (:func:`_contract`, ``basic._mean_sq``): the
  card's float32 GEMM picks its kernel, and so its summation order, by
  the batch, so a row's result would depend on the batch it rides in (a
  decode tick of 8 slots vs one request's prefill).

What keeps the bits of the reference, RG-LRU:

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
out: the port has no model axis.  Packed weights read outside ``HDense``
(``conv_w``, rank 2, so the serving packer packs it, in nibbles along
the 4 taps under a 4-bit plan; RWKV's ``decay_a`` and ``decay_b``) are
read through ``get_qw``'s dequantization, as the reference reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import hgq
from ..core.hgq import Aux, QTensor
from .basic import HDense, _mean_sq
from .common import HGQConfig, get_qw, qweight_init


# ===========================================================================
# RWKV-6 time mix + channel mix
# ===========================================================================

DECAY_LORA = 64   # rank of the data-dependent decay's LoRA (decay_a, decay_b)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_heads: int          # head dim = d_model // n_heads
    d_ff: int
    time_chunk: int = 64


class RWKVState(NamedTuple):
    shift_a: torch.Tensor   # [B, d]  last time-mix input (after ln1)
    shift_f: torch.Tensor   # [B, d]  last channel-mix input (after ln2)
    wkv: torch.Tensor       # [B, H, N, N] recurrent state


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` summed in float64 and rounded once to float32
    (the products of float32 values are exact there): a row's result does
    not depend on the batch (see the module docstring)."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


def token_shift(state: Optional[torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    """x [B, S, d] shifted one position later, the carried ``state`` [B, d]
    (zeros without one) first."""
    first = torch.zeros_like(x[:, :1]) if state is None \
        else state[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def head_norm(yh: torch.Tensor) -> torch.Tensor:
    """The per-head group norm ``y * rsqrt(mean(y^2) + 1e-6)`` over a
    head's channels (a module function: the card's RWKV controls patch
    it)."""
    return yh * torch.rsqrt(_mean_sq(yh) + 1e-6)


class RWKVTimeMix:
    @staticmethod
    def init(gen, cfg: RWKVConfig, qcfg: HGQConfig, device=None):
        d = cfg.d_model
        H = cfg.n_heads
        N = d // H
        p: Dict[str, Any] = {"mu": torch.full((5, d), 0.5, device=device)}
        q: Dict[str, Any] = {}                                # r,k,v,g,w
        for name in ("wr", "wk", "wv", "wg"):
            p[name], q[name] = HDense.init(gen, d, d, qcfg, bias=False,
                                           device=device)
        p["wo"], q["wo"] = HDense.init(gen, d, d, qcfg, bias=False,
                                       out_q=False, device=device)
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x_w @ A) @ B))
        p["decay_w0"] = torch.full((d,), -4.0, device=device)
        p["decay_a"] = qweight_init(gen, (d, DECAY_LORA), qcfg,
                                    device=device)
        p["decay_b"] = qweight_init(gen, (DECAY_LORA, d), qcfg,
                                    device=device)
        p["bonus_u"] = torch.zeros((H, N), device=device)
        p["ln_scale"] = torch.ones((d,), device=device)
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, state: Optional[RWKVState], *,
              cfg: RWKVConfig, mode: str, aux: Optional[Aux]):
        """x [B, S, d] (the normed input) -> (out [B, S, d], new range
        states, (the new ``shift_a`` [B, d]: x's last row, the new WKV
        state [B, H, N, N])).  ``state`` None starts from zeros."""
        B, S, d = x.q.shape
        H = cfg.n_heads
        N = d // H
        newq: Dict[str, Any] = {}
        prev = token_shift(None if state is None else state.shift_a, x.q)
        mu = p["mu"]
        xz = [x.q + (prev - x.q) * mu[i] for i in range(5)]  # r,k,v,g,w

        def proj(name, xi):
            t, newq[name] = HDense.apply(p[name], q[name],
                                         QTensor(xi, x.bits), mode=mode,
                                         aux=aux)
            return t.q

        r = proj("wr", xz[0]).reshape(B, S, H, N)
        k = proj("wk", xz[1]).reshape(B, S, H, N)
        v = proj("wv", xz[2]).reshape(B, S, H, N)
        g = silu(proj("wg", xz[3]))
        wa = get_qw(p["decay_a"], mode)
        lw = torch.tanh(_contract("bsi,ij->bsj", xz[4], wa.q))
        hgq.matmul_ebops(aux, x.bits, wa.bits, d, DECAY_LORA)
        wb = get_qw(p["decay_b"], mode)
        lw = _contract("bsi,ij->bsj", lw, wb.q)
        hgq.matmul_ebops(aux, None if x.bits is None else 8.0, wb.bits,
                         DECAY_LORA, d)
        w = torch.exp(-torch.exp(p["decay_w0"] + lw))  # (0,1) decay
        w = w.reshape(B, S, H, N)
        u = p["bonus_u"]

        wkv0 = state.wkv if state is not None else torch.zeros(
            (B, H, N, N), dtype=torch.float32, device=x.q.device)
        y, wkv_out = _wkv_chunked(r, k, v, w, u, wkv0, cfg.time_chunk)
        yh = head_norm(y.to(torch.float32))
        y = (yh.reshape(B, S, d) * p["ln_scale"]).to(x.q.dtype) * g
        out, newq["wo"] = HDense.apply(p["wo"], q["wo"], QTensor(y, x.bits),
                                       mode=mode, aux=aux)
        return out, newq, (x.q[:, -1], wkv_out)


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim``, added left to right (x
    itself for one position)."""
    if x.shape[dim] == 1:
        return x
    out = x.clone()
    for t in range(1, x.shape[dim]):
        out.select(dim, t).add_(out.select(dim, t - 1))
    return out


def _wkv_chunked(r, k, v, w, u, wkv0, chunk: int):
    """Chunked WKV:  S_t = diag(w_t) S_{t-1} + k_t v_t^T ;
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).

    r/k/v/w: [B, S, H, N]; u: [H, N]; wkv0: [B, H, N, N] (k-dim x v-dim).
    Returns y [B, S, H, N], final state.  The reference's operations in
    its order (module docstring), chunk after chunk."""
    B, S, H, N = r.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    # [nc, B, H, c, N]
    resh = lambda t: t.reshape(B, nc, c, H, N).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = _cumsum(logw, 3)                            # inclusive within chunk
    tot = cum[:, :, :, -1:, :]                        # chunk total decay
    tri = torch.tril(torch.ones((c, c), device=r.device), -1)
    S_state = wkv0.to(torch.float32)
    ys = []
    for i in range(nc):
        rc_, kc_, vc_, cum_, tot_ = rc[i], kc[i], vc[i], cum[i], tot[i]
        # the state's contribution at t decays by exp(cum_{t-1}) (exclusive)
        excl = torch.cat([torch.zeros_like(cum_[:, :, :1]), cum_[:, :, :-1]],
                         dim=2)
        pre = torch.exp(excl)
        y_state = _contract("bhtn,bhnm->bhtm", rc_ * pre, S_state)
        # intra-chunk A[t, s] = (r_t exp(cum_{t-1})) . (k_s exp(-cum_s)),
        # s < t; exp(-cum_s) clipped as the reference clips it
        kd = kc_ * torch.exp(torch.clamp(-cum_, max=60.0))
        A = _contract("bhtn,bhsn->bhts", rc_ * pre, kd) * tri
        bonus = _contract("bhtn,bhtn->bht", rc_, u[None, :, None] * kc_)
        y = y_state + _contract("bhts,bhsm->bhtm", A, vc_) \
            + bonus[..., None] * vc_
        # S_out = diag(exp(tot)) S_in + sum_s exp(tot - cum_s) k_s v_s^T
        S_state = torch.exp(tot_)[:, :, 0, :, None] * S_state + _contract(
            "bhsn,bhsm->bhnm", kc_ * torch.exp(tot_ - cum_), vc_)
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)     # [B, nc * c, H, N]
    return y[:, :S].to(r.dtype), S_state


def _wkv_sequential(r, k, v, w, u, wkv0):
    """Exact sequential WKV (the reference's oracle, kept for the tests):
    the same contract as :func:`_wkv_chunked`, one position at a time."""
    S_state = wkv0.to(torch.float32)
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # [B, H, N, N]
        ys.append(_contract("bhn,bhnm->bhm", r[:, t],
                            S_state + u[None, :, :, None] * kv))
        S_state = w[:, t, :, :, None] * S_state + kv
    return torch.stack(ys, dim=1).to(r.dtype), S_state


class RWKVChannelMix:
    @staticmethod
    def init(gen, cfg: RWKVConfig, qcfg: HGQConfig, device=None):
        d = cfg.d_model
        p: Dict[str, Any] = {"mu": torch.full((2, d), 0.5, device=device)}
        q: Dict[str, Any] = {}
        p["wk"], q["wk"] = HDense.init(gen, d, cfg.d_ff, qcfg, bias=False,
                                       device=device)
        p["wv"], q["wv"] = HDense.init(gen, cfg.d_ff, d, qcfg, bias=False,
                                       out_q=False, device=device)
        p["wr"], q["wr"] = HDense.init(gen, d, d, qcfg, bias=False,
                                       device=device)
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, shift: Optional[torch.Tensor], *, mode: str,
              aux: Optional[Aux]):
        """x [B, S, d] (the normed input) -> (r * v, new range states, the
        new ``shift_f``: x's last row)."""
        newq: Dict[str, Any] = {}
        prev = token_shift(shift, x.q)
        xk = x.q + (prev - x.q) * p["mu"][0]
        xr = x.q + (prev - x.q) * p["mu"][1]
        kq, newq["wk"] = HDense.apply(p["wk"], q["wk"], QTensor(xk, x.bits),
                                      mode=mode, aux=aux, act="relu")
        # the squared ReLU's bits enter the next ~EBOPs doubled
        k2 = QTensor(kq.q * kq.q,
                     None if kq.bits is None else 2.0 * kq.bits)
        vq, newq["wv"] = HDense.apply(p["wv"], q["wv"], k2, mode=mode, aux=aux)
        rq, newq["wr"] = HDense.apply(p["wr"], q["wr"], QTensor(xr, x.bits),
                                      mode=mode, aux=aux, act="sigmoid")
        return QTensor(rq.q * vq.q, None), newq, x.q[:, -1]


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma) recurrent block
# ===========================================================================


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
