"""Plain PyTorch semantics of the quantized KV cache (counterpart of
``repro/kernels/kv_dequant/ref.py``).

``kv_quantize_ref`` is the per-row (token x kv head) 2^-f grid store,
``kv_quantize_store_ref`` that store written into the ring;
``kv_attention_ref`` is the decode attention read over the dequantized
mantissas, expression for expression the fp decode attention with the
dequant in front.  They are the plain versions the CUDA kernels of
``csrc/kv_dequant.cu`` are held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.quantizer import _exp2i, quantize_inference
from ..qmatmul.ops import (grid_exponent, mantissa_max, pack_nibbles,
                           unpack_nibbles)

NEG_INF = -1e30


def kv_grid_exponent(rows: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row grid exponent for ``[..., hd]`` rows: amax over the head
    dim -> the capped grid of ``qmatmul.grid_exponent``."""
    amax = torch.amax(torch.abs(rows.to(torch.float32)), dim=-1)
    return grid_exponent(amax, bits)


def kv_quantize_ref(rows: torch.Tensor, bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., hd]`` rows -> (int8 mantissas, int8 grid exponents [...]);
    rounding is half to even (``torch.round``)."""
    f = kv_grid_exponent(rows, bits)
    qmax = mantissa_max(bits)
    q = torch.clamp(torch.round(rows.to(torch.float32) * _exp2i(f)[..., None]),
                    -qmax, qmax).to(torch.int8)
    return q, f.to(torch.int8)


def ring_write(buf: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
               vals: torch.Tensor, S: int) -> None:
    """``buf[b, slot[b, s]] = vals[b, s]`` with the reference's drop
    semantics: slots >= W are dropped.  Valid slots never collide (the
    ring remap sends every stale alias of a slot to W), so the write
    order does not matter.  Out-of-range slots can only appear when a
    chunk is longer than the ring (S > W): only then is the mask built,
    which costs a host sync.  Positions past an unwindowed cache are
    rejected before they get here."""
    W = buf.shape[1]
    if S > W:
        keep = slot < W
        b = bidx.expand_as(slot)
        buf[b[keep], slot[keep]] = vals[keep]
    else:
        buf[bidx, slot] = vals


def kv_quantize_store_ref(kh: torch.Tensor, vh: torch.Tensor,
                          slot: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, cache_kf: torch.Tensor,
                          cache_vf: torch.Tensor, bits: int) -> None:
    """The store kernel's plain version: ``kv_quantize_ref`` of the k and v
    rows [B, S, KV, hd], ``kv_pack_ref`` where the ring holds ``hd // 2``
    bytes a row, then the four ring writes (``ring_write``) at ``slot``
    [B, S], in place."""
    B, S = slot.shape
    m_new, f_new = kv_quantize_ref(torch.stack((kh, vh)), bits)
    if cache_k.shape[-1] != kh.shape[-1]:
        m_new = kv_pack_ref(m_new)
    bidx = torch.arange(B, device=slot.device)[:, None]
    for buf, vals in ((cache_k, m_new[0]), (cache_v, m_new[1]),
                      (cache_kf, f_new[0]), (cache_vf, f_new[1])):
        ring_write(buf, bidx, slot, vals, S)


def kv_dequant_ref(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``q * 2^-f`` in fp32: the plain version of the ``kv_dequant_rows``
    kernel (``kv_dequant`` on a CPU tensor) and the attention read's
    dequant."""
    return q.to(torch.float32) * _exp2i(-f.to(torch.float32))[..., None]


def kv_pack_ref(q: torch.Tensor) -> torch.Tensor:
    return pack_nibbles(q, axis=-1)


def kv_unpack_ref(packed: torch.Tensor, hd: int) -> torch.Tensor:
    return unpack_nibbles(packed, hd, axis=-1)


def attention_mask(qpos: torch.Tensor, tpos: torch.Tensor,
                   window: Optional[int]) -> torch.Tensor:
    """[B, S, W] bool: slot visible to the query row."""
    mask = (tpos[:, None, :] <= qpos[:, :, None]) & (tpos[:, None, :] >= 0)
    if window is not None:
        mask &= (qpos[:, :, None] - tpos[:, None, :]) < window
    return mask


def kv_attention_ref(qg: torch.Tensor, km: torch.Tensor, kf: torch.Tensor,
                     vm: torch.Tensor, vf: torch.Tensor, qpos: torch.Tensor,
                     tpos: torch.Tensor, *, window: Optional[int],
                     probs_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``qg`` [B, S, KV, G, hd]; ``km``/``vm`` [B, W, KV, hd or hd // 2]
    int8; ``kf``/``vf`` [B, W, KV] int8; ``qpos`` [B, S]; ``tpos`` [B, W]
    (negative = empty).  Returns [B, S, KV, G, hd] in qg's dtype.  On the
    card it runs in full fp32 (TF32 off)."""
    B, S, KV, G, hd = qg.shape
    if qg.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 einsums
    if km.shape[-1] != hd:
        km = kv_unpack_ref(km, hd)
        vm = kv_unpack_ref(vm, hd)
    k_all = kv_dequant_ref(km, kf)                # [B, W, KV, hd] fp32
    v_all = kv_dequant_ref(vm, vf)
    scale = hd ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32), k_all) * scale
    mask = attention_mask(qpos, tpos, window)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    pt = torch.exp(s - m)
    pt = torch.where(mask, pt, torch.zeros_like(pt))
    if probs_f is not None:
        pt = quantize_inference(pt, probs_f)
    l = pt.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkh->bskgh", pt / torch.clamp(l, min=1e-20),
                     v_all)
    return o.to(qg.dtype)
