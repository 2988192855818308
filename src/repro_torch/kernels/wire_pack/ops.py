"""The wire compression kernels' wrappers (counterpart of
``repro/kernels/wire_pack/ops.py``).

Entry points take any shape, as the JAX package's do: ``quantize_leaf``
([L, P] rows and their amax), ``quantize_chunks`` (a scale per position),
``pack_chunks`` (two mantissas a byte along the last axis, a zero nibble
on an odd tail) and ``dequant_sum`` (``s`` of ``q``'s shape or one row of
scales).  The CUDA kernels of ``csrc/wire_pack.cu`` need no lane
alignment, so nothing is padded.  On CUDA tensors every entry point
launches its kernel (no fallback); on CPU tensors it takes the plain
version in ``ref.py``.  ``grid_scale`` stays plain PyTorch: it runs on
[L] amax vectors.

The collective runs one thread per rank on one card
(``dist.mesh.LocalMesh``), so the launch tallies are bumped under a lock.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Tuple

import torch

from .. import _build
from . import ref
from .ref import grid_scale

__all__ = ["dequant_sum", "grid_scale", "pack_chunks", "quantize_chunks",
           "quantize_leaf", "wire_dequant_rows", "wire_pack_rows",
           "wire_quantize_rows", "wire_quantize_sflat"]

_TALLY = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed on first use."""
    lib = _build.load("wire_pack")
    if not getattr(lib, "typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wire_quantize_rows_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll,
                                                  ci, vp]
        lib.wire_quantize_rows_launch.restype = ci
        lib.wire_quantize_sflat_launch.argtypes = [vp, vp, vp, vp, ll, ci, vp]
        lib.wire_quantize_sflat_launch.restype = ci
        lib.wire_pack_rows_launch.argtypes = [vp, vp, ll, ll, vp]
        lib.wire_pack_rows_launch.restype = ci
        lib.wire_dequant_rows_launch.argtypes = [vp, vp, vp, ll, ll, ll,
                                                 ctypes.c_float, ci, vp]
        lib.wire_dequant_rows_launch.restype = ci
        lib.typed = True
    return lib


def _count(fn, key) -> None:
    with _TALLY:
        fn.launches += 1
        fn.shapes[key] += 1


def _need(what: str, cond: bool) -> None:
    if not cond:
        raise ValueError(what)


def _cuda_contig(*ts: torch.Tensor) -> bool:
    d = ts[0].device
    return all(t.is_cuda and t.device == d and t.is_contiguous() for t in ts)


def wire_quantize_rows(rows: torch.Tensor, amax: torch.Tensor, bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel: contiguous float32 [L, P] rows + [L] amax ->
    (int8 [L, P], scale [L], float32 residual [L, P])."""
    _need("wire_quantize_rows takes contiguous float32 [L, P] CUDA rows and "
          "[L] amax", rows.ndim == 2 and _cuda_contig(rows, amax)
          and rows.dtype == amax.dtype == torch.float32
          and tuple(amax.shape) == (rows.shape[0],))
    L, P = rows.shape
    q = torch.empty((L, P), dtype=torch.int8, device=rows.device)
    s = torch.empty((L,), dtype=torch.float32, device=rows.device)
    r = torch.empty_like(rows)
    if rows.numel() == 0:
        return q, s.copy_(grid_scale(amax, bits)), r
    _build.check(_lib().wire_quantize_rows_launch(
        rows.data_ptr(), amax.data_ptr(), q.data_ptr(), s.data_ptr(),
        r.data_ptr(), L, P, bits, _build.stream_ptr(rows.device)),
        "wire_quantize_rows")
    _count(wire_quantize_rows, (L, P, bits))
    return q, s, r


def wire_quantize_sflat(e: torch.Tensor, s: torch.Tensor, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: contiguous float32 ``e`` and ``s`` of one shape ->
    (int8 mantissas, float32 residual)."""
    _need("wire_quantize_sflat takes contiguous float32 CUDA e and s of one "
          "shape", _cuda_contig(e, s) and e.shape == s.shape
          and e.dtype == s.dtype == torch.float32)
    q = torch.empty(e.shape, dtype=torch.int8, device=e.device)
    r = torch.empty_like(e)
    if e.numel() == 0:
        return q, r
    _build.check(_lib().wire_quantize_sflat_launch(
        e.data_ptr(), s.data_ptr(), q.data_ptr(), r.data_ptr(), e.numel(),
        bits, _build.stream_ptr(e.device)), "wire_quantize_sflat")
    _count(wire_quantize_sflat, (tuple(e.shape), bits))
    return q, r


def wire_pack_rows(q: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: contiguous int8 [R, C] -> [R, (C + 1) // 2]."""
    _need("wire_pack_rows takes a contiguous int8 [R, C] CUDA tensor",
          q.ndim == 2 and _cuda_contig(q) and q.dtype == torch.int8)
    R, C = q.shape
    out = torch.empty((R, (C + 1) // 2), dtype=torch.int8, device=q.device)
    if q.numel() == 0:
        return out
    _build.check(_lib().wire_pack_rows_launch(
        q.data_ptr(), out.data_ptr(), R, C, _build.stream_ptr(q.device)),
        "wire_pack_rows")
    _count(wire_pack_rows, (R, C))
    return out


def wire_dequant_rows(q: torch.Tensor, s: torch.Tensor, shift: int,
                      n: int) -> torch.Tensor:
    """The CUDA kernel: contiguous int8 [R, C] and float32 scales [R, C]
    (or one row [C]) -> float32 ``((q * 2^shift) * s) / n``."""
    _need("wire_dequant_rows takes contiguous int8 [R, C] and float32 "
          "[R, C] or [C] CUDA tensors", q.ndim == 2 and _cuda_contig(q, s)
          and q.dtype == torch.int8 and s.dtype == torch.float32
          and tuple(s.shape) in (tuple(q.shape), (q.shape[1],)))
    R, C = q.shape
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    _build.check(_lib().wire_dequant_rows_launch(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), R, C,
        C if s.ndim == 2 else 0, float(2 ** shift), n,
        _build.stream_ptr(q.device)), "wire_dequant_rows")
    _count(wire_dequant_rows, (R, C, shift, n))
    return out


# launches of each kernel, in all and by shape (and width, shift, n)
for _fn in (wire_quantize_rows, wire_quantize_sflat, wire_pack_rows,
            wire_dequant_rows):
    _fn.launches = 0
    _fn.shapes = collections.Counter()


def quantize_leaf(rows: torch.Tensor, amax: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 of one leaf in stacked-row layout: [L, P] rows + per-row
    shared amax [L] -> (int8 mantissas, 2^-f scale [L], float32
    error-feedback residual), in one pass."""
    if not rows.is_cuda:
        return ref.quantize_leaf_ref(rows, amax, bits)
    return wire_quantize_rows(rows.to(torch.float32).contiguous(),
                              amax.to(torch.float32).contiguous(), bits)


def quantize_chunks(e: torch.Tensor, s: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 with a scale per position: ``e`` and ``s`` of one shape ->
    (int8 mantissas, float32 residual)."""
    if not e.is_cuda:
        return ref.quantize_chunks_ref(e, s, bits)
    return wire_quantize_sflat(e.to(torch.float32).contiguous(),
                               s.to(torch.float32).contiguous(), bits)


def pack_chunks(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int4-range mantissas along the last axis, two per byte
    (an odd length pads one zero nibble): ``qmatmul.pack_nibbles``'s
    bytes."""
    if not q.is_cuda:
        return ref.pack_chunks_ref(q)
    lead, C = q.shape[:-1], q.shape[-1]
    packed = wire_pack_rows(q.to(torch.int8).reshape(-1, C).contiguous())
    return packed.reshape(lead + ((C + 1) // 2,))


def dequant_sum(q: torch.Tensor, s: torch.Tensor, shift: int,
                n: int) -> torch.Tensor:
    """Phase-2 decode: requantized mantissa sums -> the float32 delivered
    mean ``((q * 2^shift) * s) / n``; ``s`` has ``q``'s shape or is one
    row of scales over its last axis."""
    if not q.is_cuda:
        return ref.dequant_sum_ref(q, s, shift, n)
    shape = q.shape
    C = shape[-1] if q.ndim else 1
    s = s.to(torch.float32)
    if tuple(s.shape) == tuple(shape):
        s2 = s.reshape(-1, C).contiguous()
    elif s.numel() == C:
        s2 = s.reshape(C).contiguous()
    else:
        s2 = torch.broadcast_to(s, shape).reshape(-1, C).contiguous()
    out = wire_dequant_rows(q.to(torch.int8).reshape(-1, C).contiguous(), s2,
                            shift, n)
    return out.reshape(shape)
