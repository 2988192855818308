"""Quantized GQA attention with a KV-cache decode path (counterpart of
``repro/nn/attention.py``; the chunked no-cache forward waits for LM
training, ``TransformerLM.forward``).

Caches are updated IN PLACE: ``apply`` writes the new k/v rows into the
layer's cache view and returns the same cache object.  JAX returns a new
array instead; the engine clones every slice it keeps (see
``serving/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..core.quantizer import quantize_inference
from ..kernels.kv_dequant.ops import kv_attention_decode, kv_quantize_store
from ..kernels.kv_dequant.ref import attention_mask, ring_write
from .basic import HDense
from .common import HGQConfig, act_q_init, apply_act_q

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None      # local attention window
    causal: bool = True
    q_chunk: int = 1024
    k_chunk: int = 1024


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, W, KV, hd]
    v: torch.Tensor


class QKVCache(NamedTuple):
    """Plan-width quantized ring cache: ``k``/``v`` int8 mantissas
    ``[B, W, KV, hd]`` (``hd // 2`` nibble-packed at ``kv_bits <= 4``),
    ``kf``/``vf`` int8 per-row grid exponents ``[B, W, KV]``."""
    k: torch.Tensor
    v: torch.Tensor
    kf: torch.Tensor
    vf: torch.Tensor


def decode_positions(cache_pos: torch.Tensor, S: int) -> torch.Tensor:
    """Positions of a chunk of S new tokens: ``[S]`` for a scalar
    ``cache_pos``, ``[B, S]`` for a per-slot vector."""
    cp = torch.as_tensor(cache_pos).to(torch.int32)
    ar = torch.arange(S, dtype=torch.int32, device=cp.device)
    return cp[:, None] + ar[None, :] if cp.ndim == 1 else cp + ar


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] or [S].  The frequencies keep
    the fp32 expression exp(-log(theta) * i / half)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freqs = torch.exp(-log_theta * (torch.arange(
        half, dtype=torch.float32, device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang[:, :, None, :] if ang.ndim == 3 else ang[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class GQAAttention:
    @staticmethod
    def init(gen, cfg: AttnConfig, qcfg: HGQConfig, device=None):
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        for name, dout in (("wq", H * hd), ("wk", KV * hd), ("wv", KV * hd)):
            p[name], q[name] = HDense.init(gen, d, dout, qcfg,
                                           bias=cfg.qkv_bias, device=device)
        p["wo"], q["wo"] = HDense.init(gen, H * hd, d, qcfg, bias=False,
                                       out_q=False, device=device)
        if qcfg.enabled:
            p["probs_f"] = torch.full((), qcfg.init_act_f,
                                      dtype=torch.float32, device=device)
            f, st = act_q_init(qcfg, device=device)
            p["attnout_f"] = f
            q["attnout"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, cfg: AttnConfig, mode: str,
              aux: Optional[Aux], positions: torch.Tensor,
              cache: Union[KVCache, QKVCache, None] = None,
              cache_pos: Optional[torch.Tensor] = None,
              kv_bits: Optional[int] = None
              ) -> Tuple[QTensor, Dict[str, Any],
                         Union[KVCache, QKVCache, None]]:
        if cache is None:
            raise NotImplementedError(
                "the no-cache chunked attention forward is not ported yet")
        B, S, _ = x.q.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        dev = x.q.device
        newq: Dict[str, Any] = {}
        qt, newq["wq"] = HDense.apply(p["wq"], q["wq"], x, mode=mode, aux=aux)
        kt, newq["wk"] = HDense.apply(p["wk"], q["wk"], x, mode=mode, aux=aux)
        vt, newq["wv"] = HDense.apply(p["wv"], q["wv"], x, mode=mode, aux=aux)
        qh = rope(qt.q.reshape(B, S, H, hd), positions, cfg.rope_theta)
        kh = rope(kt.q.reshape(B, S, KV, hd), positions, cfg.rope_theta)
        vh = vt.q.reshape(B, S, KV, hd)
        probs_f = p.get("probs_f")

        # ring write: global position g lives in slot g % W (windowed) or
        # slot g; a chunk longer than the ring keeps only its newest rows
        W = cache.k.shape[1]
        cpb = torch.broadcast_to(torch.as_tensor(cache_pos, device=dev)
                                 .to(torch.int64), (B,))
        qpos = cpb[:, None] + torch.arange(S, device=dev)       # [B, S]
        if cfg.window is not None:
            last = cpb + (S - 1)
            slot = torch.where(qpos > last[:, None] - W, qpos % W,
                               torch.full_like(qpos, W))
        else:
            slot = qpos
        quantized = isinstance(cache, QKVCache)
        if quantized:
            # quantize, pack and ring write of k and v in one launch
            kv_quantize_store(kh, vh, slot, cache.k, cache.v, cache.kf,
                              cache.vf, kv_bits or 8)
        else:
            bidx = torch.arange(B, device=dev)[:, None]
            ring_write(cache.k, bidx, slot, kh.to(cache.k.dtype), S)
            ring_write(cache.v, bidx, slot, vh.to(cache.v.dtype), S)
        if cfg.window is not None:
            # slot s holds global position last - ((last - s) % W);
            # never-written slots resolve negative and are masked
            spos = torch.arange(W, device=dev)
            tpos = last[:, None] - torch.remainder(last[:, None] - spos[None],
                                                   W)
        else:
            tpos = torch.arange(W, device=dev).expand(B, W)
        if quantized:
            out = kv_attention_decode(
                qh, cache.k, cache.kf, cache.v, cache.vf,
                qpos.to(torch.int32), tpos.to(torch.int32),
                window=cfg.window, n_kv=KV, probs_f=probs_f)
        else:
            out = _decode_attention(qh, cache.k.to(torch.float32),
                                    cache.v.to(torch.float32), qpos, cfg,
                                    probs_f, mode, tpos=tpos)
        if aux is not None and qt.bits is not None and probs_f is not None:
            # analytic ~EBOPs of the dynamic QK^T / PV matmuls
            n_qk = float(B * H * S) * float(W) * hd
            b_p = torch.relu(1.0 + probs_f)
            aux.add(ebops=torch.max(qt.bits) * torch.max(kt.bits) * n_qk
                    + b_p * torch.max(vt.bits) * n_qk)
            aux.add(l1=torch.relu(probs_f))
        o = out.reshape(B, S, H * hd)
        if p.get("attnout_f") is not None:
            oq, st = apply_act_q(o, p["attnout_f"], q.get("attnout"), mode,
                                 aux)
            newq["attnout"] = st
        else:
            oq = QTensor(o, None)
        yo, newq["wo"] = HDense.apply(p["wo"], q["wo"], oq, mode=mode, aux=aux)
        return yo, newq, cache


def _quant_probs(pt: torch.Tensor, probs_f, mode: str) -> torch.Tensor:
    if probs_f is None:
        return pt
    if mode == hgq.TRAIN:
        raise NotImplementedError("TRAIN-mode probs quantizer not ported")
    return quantize_inference(pt, probs_f)


def _decode_attention(qh, k_all, v_all, qpos, cfg: AttnConfig, probs_f,
                      mode, tpos=None) -> torch.Tensor:
    """Chunk attention over the full fp cache, per-row positions.
    ``qpos`` [B, S]; ``tpos`` [B, T] (negative = empty slot)."""
    B, S, H, hd = qh.shape
    KV = cfg.n_kv
    G = H // KV
    scale = hd ** -0.5
    qg = qh.reshape(B, S, KV, G, hd).to(torch.float32)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k_all) * scale
    if tpos is None:
        tpos = torch.arange(k_all.shape[1], device=qh.device).expand(
            B, k_all.shape[1])
    mask = attention_mask(qpos, tpos, cfg.window)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    pt = torch.exp(s - m)
    pt = torch.where(mask, pt, torch.zeros_like(pt))
    pt = _quant_probs(pt, probs_f, mode)
    l = pt.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkh->bskgh", pt / torch.clamp(l, min=1e-20),
                     v_all)
    return o.reshape(B, S, H, hd).to(qh.dtype)
