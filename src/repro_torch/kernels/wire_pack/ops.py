"""The wire compression kernels' wrappers (counterpart of
``repro/kernels/wire_pack/ops.py``).

Entry points take any shape, as the JAX package's do: ``quantize_leaf``
([L, P] rows and their amax), ``quantize_chunks`` (a scale per position),
``pack_chunks`` (two mantissas a byte along the last axis, a zero nibble
on an odd tail) and ``dequant_sum`` (``s`` of ``q``'s shape or one row of
scales).  ``quantize_bucket`` and ``dequant_bucket`` are the fused
reduce's per-bucket phase 1 and decode: they take the bucket's leaves
where they lie (float32 or bfloat16, any shape) with their [L] grid
steps, and the chunk layout (``ref.bucket_layout``) is the kernels' index
arithmetic.  The CUDA kernels of ``csrc/wire_pack.cu`` need no lane
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
from typing import List, Sequence, Tuple

import torch

from .. import _build
from . import ref
from .ref import grid_scale

__all__ = ["dequant_bucket", "dequant_sum", "grid_scale", "pack_chunks",
           "quantize_bucket", "quantize_chunks", "quantize_leaf",
           "wire_dequant_bucket", "wire_dequant_rows", "wire_pack_rows",
           "wire_quantize_bucket", "wire_quantize_rows",
           "wire_quantize_sflat"]

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
        lib.wire_quantize_bucket_launch.argtypes = [vp, ci, vp, ll, ll, ci,
                                                    ci, vp]
        lib.wire_quantize_bucket_launch.restype = ci
        lib.wire_dequant_bucket_launch.argtypes = [vp, ci, vp, vp, ll, ll,
                                                   ci, ctypes.c_float, ci, vp]
        lib.wire_dequant_bucket_launch.restype = ci
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


# the most members one bucket launch takes (BUCKET_MAX_MEMBERS in
# csrc/wire_pack.cu: the table fits the 4 KB of parameter space)
BUCKET_MAX_MEMBERS = 64
_DTYPES = (torch.float32, torch.bfloat16)


def _launch_groups(count: int) -> List[range]:
    """A bucket's members, in order, in launches of at most 64."""
    return [range(i, min(i + BUCKET_MAX_MEMBERS, count))
            for i in range(0, count, BUCKET_MAX_MEMBERS)]


def _bucket_key(leaves, steps, idxs) -> tuple:
    """A launch's members as the tallies key them: (shape, L, dtype)."""
    return tuple((tuple(leaves[i].shape), steps[i].numel(),
                  str(leaves[i].dtype)[6:]) for i in idxs)


def _check_members(what: str, leaves, steps, dev, read: bool) -> None:
    """Leaves of float32 or bfloat16 (contiguous where ``read``) with
    contiguous float32 [L] steps, L dividing the leaf, all on ``dev``."""
    _need(f"{what}: {len(leaves)} leaves, {len(steps)} steps",
          len(leaves) == len(steps))
    for e, s in zip(leaves, steps):
        _need(f"{what} takes float32 or bfloat16 CUDA leaves on one device "
              f"with contiguous float32 [L] steps, L dividing the leaf",
              _cuda_contig(s) and s.device == dev and e.device == dev
              and (e.is_contiguous() or not read) and e.dtype in _DTYPES
              and s.dtype == torch.float32 and s.ndim == 1
              and s.numel() >= 1 and e.numel() % s.numel() == 0)


def _on_grid(numel: int, dtype: torch.dtype, a: int,
             device) -> torch.Tensor:
    """An uninitialized contiguous [numel] tensor whose element 0 sits ``a``
    elements past a 16-byte boundary (a < 16 / element size)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    buf = torch.empty((numel + v - 1,), dtype=dtype, device=device)
    k = (a - buf.data_ptr() // buf.element_size()) % v
    return buf[k:k + numel]


def _grid_shift(t: torch.Tensor) -> int:
    """Elements from t's first element back to a 16-byte boundary."""
    return t.data_ptr() // t.element_size() % (16 // t.element_size())


def wire_quantize_bucket(leaves: Sequence[torch.Tensor],
                         steps: Sequence[torch.Tensor], n: int,
                         bits: int = 8, nibble: bool = False
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The CUDA kernel over a bucket: contiguous float32 or bfloat16 leaves
    and their [L] float32 grid steps -> (the int8 payload [n, W] in the
    chunk layout of ``ref.bucket_layout``, each leaf's float32 residual in
    its shape: views of one buffer, each on its leaf's 16-byte grid).  One
    launch per 64 members."""
    _need("wire_quantize_bucket needs leaves", len(leaves) > 0)
    dev = leaves[0].device
    _check_members("wire_quantize_bucket", leaves, steps, dev, True)
    dims, W = ref.bucket_layout(leaves, steps, n, nibble)
    q = torch.empty((n, W), dtype=torch.int8, device=dev)
    # one residual buffer; member i's view starts where its leaf's group
    # grid puts it (at most 3 elements of gap)
    buf = torch.empty((sum(d[2] + 3 for d in dims),), dtype=torch.float32,
                      device=dev)
    base, at, res = buf.data_ptr() // 4, 0, []
    for e, (_, _, T, _, _, _) in zip(leaves, dims):
        at += (_grid_shift(e) - base - at) % 4
        res.append(buf[at:at + T])
        at += T
    lib = _lib()
    stream = _build.stream_ptr(dev)
    for grp in _launch_groups(len(leaves)):
        if not any(dims[i][2] for i in grp):
            continue
        desc = (ctypes.c_longlong * (7 * len(grp)))(*(
            v for i in grp for v in (
                leaves[i].data_ptr(), steps[i].data_ptr(), res[i].data_ptr(),
                dims[i][2], dims[i][0], dims[i][5],
                int(leaves[i].dtype == torch.bfloat16))))
        _build.check(lib.wire_quantize_bucket_launch(
            desc, len(grp), q.data_ptr(), n, W, bits, int(nibble), stream),
            "wire_quantize_bucket")
        _count(wire_quantize_bucket,
               (n, bits, bool(nibble), _bucket_key(leaves, steps, grp)))
    return q, [r.view(e.shape) for r, e in zip(res, leaves)]


def wire_dequant_bucket(q: torch.Tensor, err2c: torch.Tensor,
                        residuals: Sequence[torch.Tensor],
                        leaves: Sequence[torch.Tensor],
                        steps: Sequence[torch.Tensor], n: int, idx: int,
                        shift: int, nibble: bool = False
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The CUDA kernel over a bucket: the gathered payload (contiguous int8
    [n, W], or nibble pairs [n, W / 2]), rank ``idx``'s remainder ``err2c``
    (float32 [W]) and each leaf's float32 residual -> per leaf (delivered
    mean, new residual) in its shape and dtype.  A float32 leaf's new
    residual is its residual tensor, updated in place.  ``leaves`` give
    the shapes and dtypes (their values are not read).  One launch per 64
    members."""
    _need("wire_dequant_bucket needs leaves", len(leaves) > 0)
    dev = leaves[0].device
    _check_members("wire_dequant_bucket", leaves, steps, dev, False)
    dims, W = ref.bucket_layout(leaves, steps, n, nibble)
    _need("wire_dequant_bucket takes a contiguous int8 [n, W] (nibble: "
          "[n, W / 2]) payload, float32 [W] err2c and contiguous float32 "
          "residuals of the leaves' sizes on the leaves' device",
          _cuda_contig(q, err2c, *residuals) and q.device == dev
          and q.dtype == torch.int8 and err2c.dtype == torch.float32
          and tuple(q.shape) == (n, W // 2 if nibble else W)
          and tuple(err2c.shape) == (W,) and 0 <= idx < n
          and len(residuals) == len(leaves)
          and all(r.dtype == torch.float32 and r.numel() == e.numel()
                  for r, e in zip(residuals, leaves)))
    out = []
    for e, r in zip(leaves, residuals):
        # the delivered (and a bfloat16 residual) on the residual's grid
        a = _grid_shift(r)
        dlv = _on_grid(e.numel(), e.dtype, a, dev)
        rout = r if e.dtype == torch.float32 else _on_grid(e.numel(),
                                                           e.dtype, a, dev)
        out.append((dlv, rout))
    lib = _lib()
    stream = _build.stream_ptr(dev)
    for grp in _launch_groups(len(leaves)):
        if not any(dims[i][2] for i in grp):
            continue
        desc = (ctypes.c_longlong * (8 * len(grp)))(*(
            v for i in grp for v in (
                out[i][0].data_ptr(), residuals[i].data_ptr(),
                out[i][1].data_ptr(), steps[i].data_ptr(), dims[i][2],
                dims[i][0], dims[i][5],
                int(leaves[i].dtype == torch.bfloat16))))
        _build.check(lib.wire_dequant_bucket_launch(
            desc, len(grp), q.data_ptr(), err2c.data_ptr(), n, W, idx,
            float(2 ** shift), int(nibble), stream), "wire_dequant_bucket")
        _count(wire_dequant_bucket,
               (n, shift, bool(nibble), _bucket_key(leaves, steps, grp)))
    return [(d.view(e.shape), r.view(e.shape)) for (d, r), e in
            zip(out, leaves)]


# launches of each kernel, in all and by shape (and width, shift, n; a
# bucket launch by n, width or shift, the nibble flag and its members)
for _fn in (wire_quantize_rows, wire_quantize_sflat, wire_pack_rows,
            wire_dequant_rows, wire_quantize_bucket, wire_dequant_bucket):
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


def quantize_bucket(leaves: Sequence[torch.Tensor],
                    steps: Sequence[torch.Tensor], n: int, bits: int = 8,
                    nibble: bool = False
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Phase 1 of one bucket of the fused reduce: its leaves (float32 or
    bfloat16, any shape) and their [L] grid steps -> (the int8 payload
    [n, W] in chunk layout, each leaf's float32 residual in its shape)."""
    if not leaves[0].is_cuda:
        return ref.quantize_bucket_ref(leaves, steps, n, bits, nibble)
    return wire_quantize_bucket([e.contiguous() for e in leaves],
                                [s.to(torch.float32).contiguous()
                                 for s in steps], n, bits, nibble)


def dequant_bucket(q: torch.Tensor, err2c: torch.Tensor,
                   residuals: Sequence[torch.Tensor],
                   leaves: Sequence[torch.Tensor],
                   steps: Sequence[torch.Tensor], n: int, idx: int,
                   shift: int, nibble: bool = False
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Phase-2 decode of one bucket on rank ``idx``: the gathered payload
    as it arrived (int8 [n, W], or nibble pairs [n, W / 2]), this rank's
    own-chunk remainder [W] and the leaves' residuals from
    :func:`quantize_bucket` -> per leaf (delivered mean, new residual) in
    its shape and dtype.  On the card a float32 leaf's residual is
    updated in place."""
    if not q.is_cuda:
        return ref.dequant_bucket_ref(q, err2c, residuals, leaves, steps, n,
                                      idx, shift, nibble)
    return wire_dequant_bucket(
        q.contiguous(), err2c.to(torch.float32).contiguous(),
        [r.contiguous() for r in residuals], leaves,
        [s.to(torch.float32).contiguous() for s in steps], n, idx, shift,
        nibble)
