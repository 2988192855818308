"""Quantized GQA attention: the chunked (flash-style) train / prefill
forward, KV-cache decode, optional local window, RoPE (counterpart of
``repro/nn/attention.py``).

Without a cache, ``_chunked_attention`` runs the reference's two-level
loop over query and key chunks with an online softmax: the probabilities
are quantized per (query chunk, key chunk) pair, unnormalized, against
the running maximum of the chunks seen so far, so the chunk sizes are
part of the numbers.  The loops are plain PyTorch, as the reference's
are plain jnp (no Pallas kernel); their memory is bounded by the layer's
remat (``models/lm.py``), not by per-chunk checkpoints.  Under a
``model`` axis that divides the heads (``dist.axes.get_model_size``), k
and v are repeated to full heads first, the reference's head-TP branch:
the same numbers, KV = H and G = 1.

EBOPs: the dynamic QK^T / PV matmuls use per-tensor activation bits, so
their ~EBOPs terms are analytic in the static shapes.

Caches are updated IN PLACE: ``apply`` writes the new k/v rows into the
layer's cache view and returns the same cache object.  JAX returns a new
array instead; the engine clones every slice it keeps (see
``serving/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..core.quantizer import quantize, quantize_inference
from ..dist.axes import get_model_size
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


# int8 fp cache: k / v stored as round(x * 2^4), clipped to +-127, and read
# back as q / 16 (post-HGQ activations are range-calibrated, |k|, |v| < 8)
KV_INT8_SCALE = 16.0


def _cache_store(x: torch.Tensor, cache_dtype: torch.dtype) -> torch.Tensor:
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(x.to(torch.float32) * KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(cache_dtype)


def _cache_load(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.to(torch.float32) * (1.0 / KV_INT8_SCALE)
    return x


def decode_positions(cache_pos: torch.Tensor, S: int) -> torch.Tensor:
    """Positions of a chunk of S new tokens: ``[S]`` for a scalar
    ``cache_pos``, ``[B, S]`` for a per-slot vector."""
    cp = torch.as_tensor(cache_pos).to(torch.int32)
    ar = torch.arange(S, dtype=torch.int32, device=cp.device)
    return cp[:, None] + ar[None, :] if cp.ndim == 1 else cp + ar


def memory_tpos(mem_len: torch.Tensor, T: int) -> torch.Tensor:
    """Slot positions [B, T] of a linearly filled (non-ring) memory of
    width T holding ``mem_len[b]`` valid rows: slot t carries position t
    while t < mem_len, else -1 (the empty-slot sentinel of the decode
    masks); ``mem_len == 0`` masks every slot."""
    mem = torch.as_tensor(mem_len).to(torch.int32)
    ar = torch.arange(T, dtype=torch.int32, device=mem.device)
    return torch.where(ar[None, :] < mem[:, None], ar[None, :],
                       torch.full((), -1, dtype=torch.int32,
                                  device=mem.device))


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
              kv_bits: Optional[int] = None,
              weights: Optional[Dict[str, Dict[str, QTensor]]] = None
              ) -> Tuple[QTensor, Dict[str, Any],
                         Union[KVCache, QKVCache, None]]:
        """Without ``cache``: the chunked forward over the S positions of
        x (``positions`` = 0..S-1).  With one: decode, the new rows
        written at ``cache_pos``.  ``weights``: each projection's
        quantized kernel and bias, made beforehand (``HDense.apply``'s
        ``wq``, by projection name)."""
        B, S, _ = x.q.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        w = weights or {}
        newq: Dict[str, Any] = {}
        qt, newq["wq"] = HDense.apply(p["wq"], q["wq"], x, mode=mode, aux=aux,
                                      wq=w.get("wq"))
        kt, newq["wk"] = HDense.apply(p["wk"], q["wk"], x, mode=mode, aux=aux,
                                      wq=w.get("wk"))
        vt, newq["wv"] = HDense.apply(p["wv"], q["wv"], x, mode=mode, aux=aux,
                                      wq=w.get("wv"))
        qh = rope(qt.q.reshape(B, S, H, hd), positions, cfg.rope_theta)
        kh = rope(kt.q.reshape(B, S, KV, hd), positions, cfg.rope_theta)
        vh = vt.q.reshape(B, S, KV, hd)
        probs_f = p.get("probs_f")
        if cache is None:
            out = _chunked_attention(qh, kh, vh, positions, cfg, probs_f,
                                     mode)
            kv_len = S
        else:
            out = _cached_attention(qh, kh, vh, cache, cache_pos, cfg,
                                    probs_f, mode, kv_bits)
            kv_len = cache.k.shape[1]
        if aux is not None and qt.bits is not None and probs_f is not None:
            # analytic ~EBOPs of the dynamic QK^T / PV matmuls
            n_qk = float(B * H * S) * float(kv_len) * hd
            b_p = torch.relu(1.0 + probs_f)  # p~ in [0, 1] => i' = 1
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
        yo, newq["wo"] = HDense.apply(p["wo"], q["wo"], oq, mode=mode, aux=aux,
                                      wq=w.get("wo"))
        return yo, newq, cache


def _cached_attention(qh, kh, vh, cache: Union[KVCache, QKVCache], cache_pos,
                      cfg: AttnConfig, probs_f, mode: str,
                      kv_bits: Optional[int]) -> torch.Tensor:
    """Decode: write the new k / v rows into the ring (in place), attend
    over it.  Global position g lives in slot g % W (windowed) or slot g;
    a chunk longer than the ring keeps only its newest rows."""
    B, S = qh.shape[:2]
    dev = qh.device
    W = cache.k.shape[1]
    cpb = torch.broadcast_to(torch.as_tensor(cache_pos, device=dev)
                             .to(torch.int64), (B,))
    qpos = cpb[:, None] + torch.arange(S, device=dev)           # [B, S]
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
        ring_write(cache.k, bidx, slot, _cache_store(kh, cache.k.dtype), S)
        ring_write(cache.v, bidx, slot, _cache_store(vh, cache.v.dtype), S)
    if cfg.window is not None:
        # slot s holds global position last - ((last - s) % W);
        # never-written slots resolve negative and are masked
        spos = torch.arange(W, device=dev)
        tpos = last[:, None] - torch.remainder(last[:, None] - spos[None], W)
    else:
        tpos = torch.arange(W, device=dev).expand(B, W)
    if quantized:
        return kv_attention_decode(
            qh, cache.k, cache.kf, cache.v, cache.vf, qpos.to(torch.int32),
            tpos.to(torch.int32), window=cfg.window, n_kv=cfg.n_kv,
            probs_f=probs_f)
    return _decode_attention(qh, _cache_load(cache.k).to(torch.float32),
                             _cache_load(cache.v).to(torch.float32), qpos,
                             cfg, probs_f, mode, tpos=tpos)


def _quant_probs(pt: torch.Tensor, probs_f, mode: str) -> torch.Tensor:
    if probs_f is None:
        return pt
    return (quantize if mode == hgq.TRAIN else quantize_inference)(pt,
                                                                   probs_f)


def _group_heads(qh: torch.Tensor, KV: int) -> torch.Tensor:
    """[B, S, H, hd] -> [B, KV, G, S, hd]."""
    B, S, H, hd = qh.shape
    return qh.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def _chunked_attention(qh, kh, vh, positions, cfg: AttnConfig, probs_f,
                       mode: str) -> torch.Tensor:
    """Online-softmax attention over query chunks of ``min(q_chunk, S)``
    rows and key chunks of ``min(k_chunk, S)``, both padded up to whole
    chunks (padded keys masked, padded query rows dropped): qh [B, S, H,
    hd], kh / vh [B, S, KV, hd] at positions 0..S-1 -> [B, S, H, hd].
    Each pair's probabilities ``exp(s - m_new)`` are quantized before
    they are summed, as the reference does (``NEG_INF`` masks,
    ``max(l, 1e-20)``)."""
    del positions        # the reference's chunks sit at positions 0..S-1
    B, S, H, hd = qh.shape
    msize = get_model_size()
    if msize > 1 and H % msize == 0:
        # head TP: k / v at full heads, so heads shard over model
        G = H // cfg.n_kv
        kh = torch.repeat_interleave(kh, G, dim=2)       # [B, S, H, hd]
        vh = torch.repeat_interleave(vh, G, dim=2)
        KV, G = H, 1
    else:
        KV = cfg.n_kv
        G = H // KV
    dev = qh.device
    scale = hd ** -0.5
    cq = min(cfg.q_chunk, S)
    ck = min(cfg.k_chunk, S)
    nq, nk = -(-S // cq), -(-S // ck)
    qg = F.pad(_group_heads(qh, KV), (0, 0, 0, nq * cq - S))
    kg = F.pad(kh.transpose(1, 2), (0, 0, 0, nk * ck - S))   # [B, KV, S', hd]
    vg = F.pad(vh.transpose(1, 2), (0, 0, 0, nk * ck - S))
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    outs = []
    for qi in range(nq):
        qc = qg[:, :, :, qi * cq:(qi + 1) * cq]             # [B,KV,G,cq,hd]
        qpos = qi * cq + torch.arange(cq, device=dev)
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, cq, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kc = kg[:, :, ki * ck:(ki + 1) * ck]            # [B, KV, ck, hd]
            vc = vg[:, :, ki * ck:(ki + 1) * ck]
            kpos = ki * ck + torch.arange(ck, device=dev)
            # float32 products and sums, whatever the compute dtype (the
            # reference's preferred_element_type)
            s = torch.einsum("bkgqh,bkch->bkgqc", qc.to(torch.float32),
                             kc.to(torch.float32)) * scale
            mask = (kpos < S)[None, :].expand(cq, ck)     # key padding
            if cfg.causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if cfg.window is not None:
                mask = mask & ((qpos[:, None] - kpos[None, :]) < cfg.window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            pt = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
            pt = _quant_probs(pt, probs_f, mode)
            corr = torch.exp(m - m_new)
            l = l * corr + pt.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqc,bkch->bkgqh", pt, vc.to(torch.float32))
            m = m_new
        outs.append((o / torch.clamp(l, min=1e-20)[..., None]).to(qh.dtype))
    # [nq, B, KV, G, cq, hd] -> [B, S, H, hd]
    out = torch.stack(outs).permute(1, 2, 3, 0, 4, 5).reshape(
        B, H, nq * cq, hd)
    return out[:, :, :S].transpose(1, 2).to(qh.dtype)


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
