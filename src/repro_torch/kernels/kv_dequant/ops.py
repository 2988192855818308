"""Quantized KV cache: the store quantizer and the fused attention read
(counterpart of ``repro/kernels/kv_dequant/ops.py``).

Entry points take the cache-native layouts (``[B, W, KV, hdm]``
mantissas, ``[B, W, KV]`` exponents).  On CUDA tensors ``kv_quantize``,
``kv_quantize_store``, ``kv_dequant`` and ``kv_attention_decode`` launch
the hand-written kernels of ``csrc/kv_dequant.cu`` (no fallback); on CPU
tensors they take the plain versions in ``ref.py``.  The serving path
stores a layer's new k and v rows with ``kv_quantize_store``: quantize,
nibble-pack and ring write in one launch.  ``kv_pack`` and ``kv_unpack``
are plain PyTorch everywhere.  (The serving path never dequantizes the
cache: its attention read folds the dequant in; ``kv_quantize`` and
``kv_dequant`` are the op's public entry points, as in the JAX package.)
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from . import ref

__all__ = ["attention_cluster", "kv_attention_decode", "kv_attention_rows",
           "kv_dequant", "kv_dequant_rows", "kv_pack", "kv_quantize",
           "kv_quantize_rows", "kv_quantize_store", "kv_unpack"]


def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed on first use."""
    lib = _build.load("kv_dequant")
    if not getattr(lib, "typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_quantize_launch.argtypes = [vp, ll, vp, vp, ci, ci, ci, ci,
                                           vp]
        lib.kv_quantize_launch.restype = ci
        lib.kv_store_launch.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp,
                                        vp, vp, ll, ll, ll, vp, vp, ll, ll,
                                        ll, ci, ci, ci, ci, ci, ci, ci, ci,
                                        vp]
        lib.kv_store_launch.restype = ci
        lib.kv_dequant_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.kv_dequant_launch.restype = ci
        lib.kv_attention_launch.argtypes = [
            vp, vp, vp, ll, ll, ll, vp, vp, ll, ll, ll, vp, vp, ll, ll, vp,
            vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, vp]
        lib.kv_attention_launch.restype = ci
        lib.typed = True
    return lib


_ROW_DTYPES = (torch.float32, torch.bfloat16)


def kv_quantize_rows(rows: torch.Tensor, bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: [R, hd] float32 or bfloat16 rows, the last axis
    contiguous -> (int8 mantissas [R, hd], int8 grid exponents [R])."""
    if not rows.is_cuda or rows.dtype not in _ROW_DTYPES \
            or rows.ndim != 2 or (rows.shape[1] > 1 and rows.stride(1) != 1):
        raise ValueError("kv_quantize_rows takes float32 or bfloat16 [R, hd] "
                         "CUDA rows, the last axis contiguous")
    R, hd = rows.shape
    q = torch.empty((R, hd), dtype=torch.int8, device=rows.device)
    f = torch.empty((R,), dtype=torch.int8, device=rows.device)
    if R == 0 or hd == 0:
        return q, f
    _build.check(_lib().kv_quantize_launch(
        rows.data_ptr(), rows.stride(0), q.data_ptr(), f.data_ptr(), R, hd,
        bits, int(rows.dtype == torch.bfloat16),
        _build.stream_ptr(rows.device)), "kv_quantize_rows")
    kv_quantize_rows.launches += 1
    kv_quantize_rows.shapes[R, hd, bits] += 1
    return q, f


# launches of the kernel, in all and by (R, hd, bits)
kv_quantize_rows.launches = 0
kv_quantize_rows.shapes = collections.Counter()


def kv_quantize(x: torch.Tensor, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., hd]`` k/v rows -> (int8 mantissas ``[..., hd]``, int8 grid
    exponents ``[...]``)."""
    if not x.is_cuda:
        return ref.kv_quantize_ref(x, bits)
    lead, hd = x.shape[:-1], x.shape[-1]
    if x.dtype not in _ROW_DTYPES:
        x = x.to(torch.float32)
    rows = x.reshape(-1, hd)
    if hd > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    q, f = kv_quantize_rows(rows, bits)
    return q.reshape(lead + (hd,)), f.reshape(lead)


def kv_quantize_store(kh: torch.Tensor, vh: torch.Tensor,
                      slot: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, cache_kf: torch.Tensor,
                      cache_vf: torch.Tensor, bits: int) -> None:
    """Store a layer's new k and v rows into its quantized ring, in place:
    ``kh``/``vh`` [B, S, KV, hd] (float32 or bfloat16, any strides with
    the last axis contiguous) are quantized per row (``kv_quantize``),
    nibble-packed where the ring holds ``hd // 2`` bytes a row, and written
    with their exponents to ``cache_*[b, slot[b, s]]``; slots outside the
    ring (``>= W``) are dropped, as the reference's ``mode="drop"``
    scatter drops them.  On CUDA one launch of the store kernel, on the
    CPU the plain version."""
    if not kh.is_cuda:
        ref.kv_quantize_store_ref(kh, vh, slot, cache_k, cache_v, cache_kf,
                                  cache_vf, bits)
        return
    B, S, KV, hd = kh.shape
    W, hdm = cache_k.shape[1], cache_k.shape[3]
    tensors = (kh, vh, slot, cache_k, cache_v, cache_kf, cache_vf)
    if not all(t.is_cuda and t.device == kh.device for t in tensors):
        raise ValueError("kv_quantize_store needs its tensors on one CUDA "
                         "device")
    if kh.dtype not in _ROW_DTYPES or vh.dtype != kh.dtype:
        raise TypeError(f"kv_quantize_store takes float32 or bfloat16 k/v "
                        f"rows of one dtype, got {kh.dtype}, {vh.dtype}")
    if any(t.dtype != torch.int8 for t in tensors[3:]):
        raise TypeError("kv_quantize_store writes int8 rings")
    if tuple(vh.shape) != (B, S, KV, hd) or tuple(slot.shape) != (B, S) \
            or hdm not in (hd, hd // 2) or (hdm != hd and hd % 2) \
            or tuple(cache_k.shape) != (B, W, KV, hdm) \
            or tuple(cache_v.shape) != (B, W, KV, hdm) \
            or tuple(cache_kf.shape) != (B, W, KV) \
            or tuple(cache_vf.shape) != (B, W, KV):
        raise ValueError(f"kv_quantize_store shapes k{tuple(kh.shape)} "
                         f"v{tuple(vh.shape)} slot{tuple(slot.shape)} ring "
                         f"{tuple(cache_k.shape)} {tuple(cache_v.shape)} "
                         f"{tuple(cache_kf.shape)} {tuple(cache_vf.shape)}")
    if (hd > 1 and (kh.stride(3) != 1 or vh.stride(3) != 1)) \
            or cache_k.stride() != cache_v.stride() \
            or cache_kf.stride() != cache_vf.stride() \
            or (hdm > 1 and cache_k.stride(3) != 1):
        raise ValueError("kv_quantize_store needs contiguous rows and k and "
                         "v rings that share strides")
    if kh.numel() == 0:
        return
    slot = slot.to(torch.int64).contiguous()
    _build.check(_lib().kv_store_launch(
        kh.data_ptr(), *kh.stride()[:3], vh.data_ptr(), *vh.stride()[:3],
        slot.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        *cache_k.stride()[:3], cache_kf.data_ptr(), cache_vf.data_ptr(),
        *cache_kf.stride(), B, S, KV, hd, W, int(hdm != hd), bits,
        int(kh.dtype == torch.bfloat16), _build.stream_ptr(kh.device)),
        "kv_quantize_store")
    kv_quantize_store.launches += 1
    kv_quantize_store.shapes[B, S, KV, hd, W, hdm, bits,
                             str(kh.dtype).replace("torch.", "")] += 1


# launches of the kernel, in all and by (B, S, KV, hd, W, hdm, bits, dtype)
kv_quantize_store.launches = 0
kv_quantize_store.shapes = collections.Counter()


def kv_dequant_rows(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: [R, hd] int8 contiguous mantissas, [R] int8
    exponents -> [R, hd] fp32 ``q * 2^-f``, bit-exact."""
    if not (q.is_cuda and f.is_cuda):
        raise ValueError("kv_dequant_rows needs CUDA tensors")
    if q.dtype != torch.int8 or f.dtype != torch.int8:
        raise TypeError("kv_dequant_rows takes int8 mantissas and exponents")
    if q.ndim != 2 or tuple(f.shape) != (q.shape[0],) \
            or not (q.is_contiguous() and f.is_contiguous()):
        raise ValueError(f"kv_dequant_rows takes contiguous [R, hd] / [R], got "
                         f"q{tuple(q.shape)} f{tuple(f.shape)}")
    R, hd = q.shape
    out = torch.empty((R, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    vec = hd % 16 == 0 and q.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    _build.check(_lib().kv_dequant_launch(
        q.data_ptr(), f.data_ptr(), out.data_ptr(), R, hd, int(vec),
        _build.stream_ptr(q.device)), "kv_dequant_rows")
    kv_dequant_rows.launches += 1
    kv_dequant_rows.shapes[R, hd] += 1
    return out


# launches of the kernel, in all and by (R, hd)
kv_dequant_rows.launches = 0
kv_dequant_rows.shapes = collections.Counter()


def kv_dequant(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(int8 mantissas ``[..., hd]``, int8 exponents ``[...]``) -> fp32
    ``q * 2^-f``."""
    if not q.is_cuda:
        return ref.kv_dequant_ref(q, f)
    lead, hd = q.shape[:-1], q.shape[-1]
    out = kv_dequant_rows(q.to(torch.int8).reshape(-1, hd).contiguous(),
                          f.to(torch.int8).reshape(-1).contiguous())
    return out.reshape(lead + (hd,))


def kv_pack(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int4-range mantissas two per byte along the head dim."""
    return ref.kv_pack_ref(q)


def kv_unpack(packed: torch.Tensor, hd: int) -> torch.Tensor:
    return ref.kv_unpack_ref(packed, hd)


# ring slots a block of the attention kernel's cluster owns at least, and
# the most blocks a cluster may have (the portable cluster size)
CLUSTER_SLOTS, CLUSTER_MAX = 128, 8


def attention_cluster(W: int) -> int:
    """Blocks that share one ring of ``W`` slots in ``kv_attention_rows``
    (8 at W = 1024): from W alone, so a request's rows are summed in the
    same order in any batch."""
    return max(1, min(CLUSTER_MAX, -(-W // CLUSTER_SLOTS)))


def kv_attention_rows(qh: torch.Tensor, km: torch.Tensor, kf: torch.Tensor,
                      vm: torch.Tensor, vf: torch.Tensor, qpos: torch.Tensor,
                      tpos: torch.Tensor, *, window: Optional[int],
                      n_kv: int, probs_f: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The CUDA kernel: fused dequant-attention decode read over the ring
    in its native layout.  ``qh`` [B, S, H, hd] fp32 contiguous; ``km``/
    ``vm`` [B, W, KV, hdm] int8, last axis contiguous, same strides;
    ``kf``/``vf`` [B, W, KV] int8, same strides; ``qpos`` [B, S] int32
    contiguous; ``tpos`` [B, W] int32 (any strides, e.g. a broadcast
    ``arange``); ``probs_f`` a one-element fp32 CUDA tensor or None.
    Returns [B, S, H, hd] fp32."""
    B, S, H, hd = qh.shape
    W, KV, hdm = km.shape[1], km.shape[2], km.shape[3]
    tensors = (qh, km, kf, vm, vf, qpos, tpos) + \
        (() if probs_f is None else (probs_f,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("kv_attention_rows needs CUDA tensors")
    if qh.dtype != torch.float32 or not qh.is_contiguous():
        raise ValueError("qh must be contiguous fp32")
    if km.dtype != torch.int8 or vm.dtype != torch.int8 \
            or kf.dtype != torch.int8 or vf.dtype != torch.int8:
        raise TypeError("mantissas and exponents must be int8")
    if KV != n_kv or H % KV or hdm not in (hd, hd // 2) or hd % 2 \
            or tuple(km.shape) != (B, W, KV, hdm) \
            or tuple(kf.shape) != (B, W, KV):
        raise ValueError(f"kv_attention_rows shapes qh{tuple(qh.shape)} "
                         f"km{tuple(km.shape)} kf{tuple(kf.shape)}")
    if km.stride() != vm.stride() or km.stride(3) != 1 \
            or kf.stride() != vf.stride():
        raise ValueError("k and v buffers must share strides, last axis "
                         "contiguous")
    if qpos.dtype != torch.int32 or tpos.dtype != torch.int32 \
            or not qpos.is_contiguous() or tuple(qpos.shape) != (B, S) \
            or tuple(tpos.shape) != (B, W):
        raise ValueError("qpos [B, S] / tpos [B, W] must be int32")
    if probs_f is not None and (probs_f.dtype != torch.float32
                                or probs_f.numel() != 1):
        raise ValueError("probs_f must be a one-element fp32 tensor")
    # 16-byte staging loads need 16-byte aligned rows and strides
    vec = hdm % 16 == 0 and all(
        v % 16 == 0 for v in (km.data_ptr(), vm.data_ptr(), *km.stride()[:3]))
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=qh.device)
    _build.check(_lib().kv_attention_launch(
        qh.data_ptr(), km.data_ptr(), vm.data_ptr(),
        km.stride(0), km.stride(1), km.stride(2),
        kf.data_ptr(), vf.data_ptr(), kf.stride(0), kf.stride(1),
        kf.stride(2), qpos.data_ptr(), tpos.data_ptr(), tpos.stride(0),
        tpos.stride(1), None if probs_f is None else probs_f.data_ptr(),
        out.data_ptr(), B, S, H, KV, W, hd, int(hdm != hd), int(vec),
        -1 if window is None else int(window), float(hd) ** -0.5,
        attention_cluster(W), _build.stream_ptr(qh.device)),
        "kv_attention_rows")
    kv_attention_rows.launches += 1
    kv_attention_rows.shapes[B, S, H, KV, hd, W, hdm] += 1
    return out


# launches of the kernel, in all and by (B, S, H, KV, hd, W, hdm)
kv_attention_rows.launches = 0
kv_attention_rows.shapes = collections.Counter()


def kv_attention_decode(qh: torch.Tensor, km: torch.Tensor, kf: torch.Tensor,
                        vm: torch.Tensor, vf: torch.Tensor,
                        qpos: torch.Tensor, tpos: torch.Tensor, *,
                        window: Optional[int], n_kv: int,
                        probs_f: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decode attention over the quantized ring cache, dequant fused.
    ``qh`` [B, S, H, hd] roped queries; returns [B, S, H, hd] in qh's
    dtype (the contract of the fp decode attention)."""
    B, S, H, hd = qh.shape
    if not qh.is_cuda:
        qg = qh.reshape(B, S, n_kv, H // n_kv, hd)
        out = ref.kv_attention_ref(qg, km, kf, vm, vf, qpos, tpos,
                                   window=window, probs_f=probs_f)
        return out.reshape(B, S, H, hd)
    pf = None if probs_f is None else \
        torch.as_tensor(probs_f, dtype=torch.float32,
                        device=qh.device).reshape(1)
    out = kv_attention_rows(
        qh.to(torch.float32).contiguous(), km, kf, vm, vf,
        qpos.to(torch.int32).contiguous(), tpos.to(torch.int32),
        window=window, n_kv=n_kv, probs_f=pf)
    return out.to(qh.dtype)
