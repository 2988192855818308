"""Compressed data-parallel gradient reduce: the reduction itself moves
int8 (or nibble, or bf16) bytes, not float32 (counterpart of the 1D half
of ``repro/dist/collectives.py``).

Error feedback on both phases, as in the reference:

phase 1 (reduce-scatter as ``all_to_all``)
    Each data shard quantizes its ``grad + residual`` to mantissas on a
    per-layer power-of-two grid ``2^-f`` (``kernels.wire_pack``; the amax
    is ``pmax``-shared, so every shard lands on one grid and the int32
    chunk sums are exact).  The chunks are exchanged and summed as int32.
phase 2 (``all_gather``)
    The chunk owner shifts the sum right by ``ceil(log2 n)`` bits back
    into the phase-1 width, gathers, and keeps the shift remainder in its
    residual, so the time-averaged delivered mean telescopes to the true
    mean.

Per-device bytes per gradient element: ``2 (n-1)/n`` at 1 byte (int8),
half that for nibble leaves (plan widths <= 4), against ``2 (n-1)/n`` at
4 bytes for a ring float32 all-reduce.

The bodies are written for one rank of a data mesh (``dist.mesh``): a
:class:`~repro_torch.dist.mesh.LocalMesh` runs ``n`` ranks as threads on
one device, a :class:`~repro_torch.dist.mesh.ProcessGroupMesh` one rank
per process.  Two strategies share the math, bit for bit:

fused (default)
    One amax ``pmax`` for the whole tree; leaves grouped into
    width-homogeneous, size-bucketed buffers of column-concatenated chunks
    (nibble leaves pre-padded to even columns), each bucket quantized by
    ``wire_quantize_bucket``, packed by ``wire_pack_rows`` and decoded by
    ``wire_dequant_bucket``, one launch each a bucket: the bucket kernels
    read and write the leaves where they lie, the chunk layout is their
    index arithmetic; bucket k's exchange is issued before bucket k+1 is
    built.  The ``bf16`` kind builds the layout in PyTorch.
per-leaf (``fused=False``)
    One set of collectives per leaf, phase 1 through ``wire_quantize_rows``
    and the rest plain PyTorch: the executable reference of the fused
    path.

:func:`simulate_wire_pmean` is the collective-free reference on a stacked
``[n, ...]`` tree.  The 2D sliced exchange over a tensor-parallel
``model`` axis (``ef_wire_pmean_2d``) is not ported yet.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.plan import NIBBLE_BITS
from ..kernels import wire_pack as wp
from ..kernels.qmatmul.ops import pack_nibbles, unpack_nibbles
from ..kernels.wire_pack.ref import dequant_sum_ref, true_div
from ..kernels.wire_pack.ref import own_chunk as _own_chunk
from ..tree import tree_leaves, tree_map, tree_unflatten
from .scope import Scoped
from .sharding import stacked_tree

WIRE_KINDS = ("int8", "bf16")

# fused-path bucket budget: wire payload bytes per pipelined buffer
_WIRE_BUCKET_BYTES = 1 << 20

# recorder for bytes-on-wire accounting: (op, per-device bytes) per
# collective issued inside a record_wire_bytes block
_BYTES_TRACE: Scoped[Optional[List[Tuple[str, float]]]] = Scoped(
    "repro_torch.dist.wire_bytes", None)


class record_wire_bytes:
    """Context manager: collect (op, per-device payload bytes) tuples for
    every collective the wire reduce issues inside the block (one rank of
    a mesh records, as one trace does in the reference)."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []
        self._cm = None

    def __enter__(self):
        self._cm = _BYTES_TRACE.scope(self.records)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        cm, self._cm = self._cm, None
        return cm.__exit__(*exc)

    def total(self) -> float:
        return sum(b for _, b in self.records)


def _record(op: str, nbytes: float) -> None:
    records = _BYTES_TRACE.get()
    if records is not None:
        records.append((op, float(nbytes)))


def _rec(rank, op: str, nbytes: float) -> None:
    if rank.records:
        _record(op, nbytes)


def _ring_allreduce_bytes(nbytes: float, n: int) -> float:
    return 2.0 * (n - 1) / n * nbytes


def data_axis_size(mesh) -> int:
    """Data ranks of ``mesh`` (1 for ``None``)."""
    return 1 if mesh is None else int(mesh.size)


# ---------------------------------------------------------------------------
# per-shard quantization (shared by the bodies and the simulator)
# ---------------------------------------------------------------------------

def _stacked_flags(tree: Any, stacked: Any) -> Tuple[bool, ...]:
    """Per-leaf stacked-layer flags in flatten order; ``None`` derives
    them from the tree paths (``sharding.stacked_tree``)."""
    marks = stacked_tree(tree) if stacked is None else stacked
    return tuple(bool(m) for m in tree_leaves(marks))


def _width_flags(tree: Any, widths: Any) -> Tuple[int, ...]:
    """Per-leaf wire widths in flatten order; ``None`` is uniform int8."""
    if widths is None:
        return tuple(8 for _ in tree_leaves(tree))
    vals = tuple(int(w) for w in tree_leaves(widths))
    for w in vals:
        if not 2 <= w <= 8:
            raise ValueError(f"wire width must be in [2, 8], got {w!r}")
    return vals


def _nibble_wire(kind: str, bits: int) -> bool:
    """True when this leaf's payload rides nibble-packed bytes."""
    return kind == "int8" and bits <= NIBBLE_BITS


def _layer_rows(e: torch.Tensor, stacked: bool) -> torch.Tensor:
    """A leaf as [L, P] float32 rows: one grid per layer for stacked rank
    >= 3 leaves, one per tensor otherwise."""
    L = e.shape[0] if (stacked and e.ndim >= 3) else 1
    return e.to(torch.float32).reshape(L, -1)


def _phase1_quantize(e: torch.Tensor, amax_rows: Optional[torch.Tensor],
                     kind: str, stacked: bool, bits: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf for the wire: (payload [L, P], per-row grid step, residual
    ``e - dequant``).  ``amax_rows`` is the global per-row amax."""
    rows = _layer_rows(e, stacked)
    if kind == "bf16":
        payload = rows.to(torch.bfloat16)
        scale = torch.ones((rows.shape[0],), dtype=torch.float32,
                           device=e.device)
        residual = (e.to(torch.float32)
                    - payload.to(torch.float32).reshape(e.shape))
        return payload, scale, residual
    payload, scale, res_rows = wp.quantize_leaf(rows, amax_rows, bits)
    return payload, scale, res_rows.reshape(e.shape)


def _chunk_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    return x.to(torch.float32 if kind == "bf16" else torch.int32).sum(dim=0)


def _phase2_requantize(chunk_sum: torch.Tensor, n: int, kind: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk of summed payloads back into the wire width: int8 shifts the
    int32 sum right by ``ceil(log2 n)`` bits (remainder in mantissa
    units); bf16 rounds the float32 sum (error in value units)."""
    if kind == "bf16":
        payload = chunk_sum.to(torch.bfloat16)
        return payload, chunk_sum - payload.to(torch.float32)
    k = _phase2_shift(n)
    m2 = torch.round(chunk_sum.to(torch.float32) / (2 ** k)).to(torch.int32)
    err = (chunk_sum - m2 * (2 ** k)).to(torch.float32)
    return m2.to(torch.int8), err


def _phase2_shift(n: int) -> int:
    """``ceil(log2 n)``: the requantized sum stays inside the phase-1 width
    for any width, so mixed int4/int8 leaves share it."""
    return max((n - 1).bit_length(), 0)


# ---------------------------------------------------------------------------
# per-leaf body
# ---------------------------------------------------------------------------

def _wire_leaf(e: torch.Tensor, rank, n: int, kind: str, stacked: bool,
               bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed mean-reduce of one leaf on one rank: ``e`` is this
    shard's ``grad + residual``; returns (delivered mean, new residual)."""
    dtype = e.dtype
    rows = _layer_rows(e, stacked)
    L, Pn = rows.shape
    amax = None
    if kind != "bf16":     # bf16 payloads carry their own exponents
        amax = rank.pmax(torch.amax(torch.abs(rows), dim=1))
        _rec(rank, "pmax.scale", _ring_allreduce_bytes(L * 4, n))
    payload, scale, residual = _phase1_quantize(e, amax, kind, stacked, bits)

    flat = payload.reshape(-1)
    T = flat.shape[0]
    C = -(-T // n)
    flat = F.pad(flat, (0, n * C - T))
    s_flat = F.pad(scale[:, None].expand(L, Pn).reshape(-1), (0, n * C - T),
                   value=1.0)
    nib = _nibble_wire(kind, bits)
    wtag = "int4" if nib else kind

    # phase 1: reduce-scatter as all_to_all of the compressed chunks
    if nib:
        pk = pack_nibbles(flat.reshape(n, C), axis=-1)
        _rec(rank, f"all_to_all.{wtag}",
             (n - 1) / n * (n * pk.shape[-1]) * pk.element_size())
        ex = unpack_nibbles(rank.all_to_all(pk), C, axis=-1)
    else:
        _rec(rank, f"all_to_all.{wtag}",
             (n - 1) / n * (n * C) * flat.element_size())
        ex = rank.all_to_all(flat.reshape(n, C))
    chunk_sum = _chunk_sum(ex, kind)

    # phase 2: requantize the sum, gather, decode once
    q2, err2 = _phase2_requantize(chunk_sum, n, kind)
    if nib:
        q2p = pack_nibbles(q2, axis=-1)
        _rec(rank, f"all_gather.{wtag}",
             (n - 1) * q2p.shape[0] * q2p.element_size())
        full = unpack_nibbles(rank.all_gather(q2p), C, axis=-1).reshape(-1)
    else:
        _rec(rank, f"all_gather.{wtag}", (n - 1) * C * q2.element_size())
        full = rank.all_gather(q2).reshape(-1)
    idx = rank.index
    if kind == "bf16":
        delivered_flat = true_div(full.to(torch.float32), n)
        err2_val = err2              # value units
    else:
        delivered_flat = dequant_sum_ref(full, s_flat, _phase2_shift(n), n)
        err2_val = err2 * s_flat[idx * C:(idx + 1) * C]
    delivered = delivered_flat[:T].reshape(e.shape).to(dtype)
    # error feedback for phase 2: the owner of chunk idx keeps the remainder
    scatter = _own_chunk(err2_val, idx, n, C, T)
    new_residual = (residual + scatter.reshape(e.shape)).to(dtype)
    return delivered, new_residual


# ---------------------------------------------------------------------------
# fused / pipelined tree-level body
# ---------------------------------------------------------------------------

def _bucket_leaves(byte_sizes: Sequence[float], bucket_bytes: int
                   ) -> List[List[int]]:
    """Greedy size-bucketed partition of leaf indices, largest first: each
    bucket's payload stays under ``bucket_bytes`` (an oversized leaf gets
    its own bucket).  Deterministic in the leaf order."""
    order = sorted(range(len(byte_sizes)),
                   key=lambda i: (-byte_sizes[i], i))
    buckets, cur, acc = [], [], 0.0
    for i in order:
        if cur and acc + byte_sizes[i] > bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0.0
        cur.append(i)
        acc += byte_sizes[i]
    if cur:
        buckets.append(cur)
    return buckets


def _pipelined_collective(buckets, build, collective):
    """Bucket k's collective is issued before bucket k+1's payload is
    built, so compression can overlap the bytes in flight."""
    if not buckets:
        return []
    outs = [None] * len(buckets)
    pending = build(0)
    for b in range(len(buckets)):
        inflight = collective(pending)
        if b + 1 < len(buckets):
            pending = build(b + 1)
        outs[b] = inflight
    return outs


def _wire_tree_fused(flat: List[torch.Tensor], rank, n: int, kind: str,
                     flags: Tuple[bool, ...], widths: Tuple[int, ...],
                     bucket_bytes: int
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The fused twin of mapping :func:`_wire_leaf` over a tree, bit for
    bit: pmax is elementwise (pmax of the concatenation = concatenation of
    the pmaxes) and the exchanges act on axis 0, so column-concatenated
    buckets split back into the per-leaf results exactly.  Byte records
    keep the per-leaf tags and values."""
    N = len(flat)
    rows = [_layer_rows(e, st) for e, st in zip(flat, flags)]
    dims = []
    for r in rows:
        L, Pn = r.shape
        T = L * Pn
        dims.append((L, Pn, T, -(-T // n)))
    nibs = [_nibble_wire(kind, b) for b in widths]
    # nibble leaves pad their chunk columns to even with a zero mantissa on
    # scale 1 (the zero nibble pack_nibbles would add), so packing the
    # concatenated bucket equals concatenating the per-leaf packs
    ceven = [(-(-C // 2) * 2 if nib else C)
             for (_, _, _, C), nib in zip(dims, nibs)]
    cols = [(ce // 2 if nib else ce) for ce, nib in zip(ceven, nibs)]
    item = 2 if kind == "bf16" else 1
    # width-homogeneous buckets: one clip bound and one nibble flag each
    classes: dict = {}
    for i in range(N):
        classes.setdefault(widths[i] if kind != "bf16" else 0, []).append(i)
    buckets = []
    for key in sorted(classes):
        idxs = classes[key]
        for b in _bucket_leaves([n * cols[i] * item for i in idxs],
                                bucket_bytes):
            buckets.append([idxs[j] for j in b])

    # grid steps per leaf row: grid_scale is elementwise, so one call per
    # width over the concatenated pmax'd amax, sliced per leaf, equals
    # one call per leaf
    steps: List[Optional[torch.Tensor]] = [None] * N
    if kind != "bf16":
        gmax = rank.pmax(torch.cat([torch.amax(torch.abs(r), dim=1)
                                    for r in rows]))
        by_width = {w: wp.grid_scale(gmax, w) for w in sorted(set(widths))}
        off = 0
        for i, (L, _, _, _) in enumerate(dims):
            steps[i] = by_width[widths[i]][off:off + L]
            off += L
            _rec(rank, "pmax.scale", _ring_allreduce_bytes(L * 4, n))

    def chunked(i):
        """One leaf's values in padded chunk layout [n, ceven] (the bf16
        kind): chunk row d is the slice rank d will own."""
        _, _, T, C = dims[i]
        e = F.pad(rows[i].reshape(-1), (0, n * C - T)).reshape(n, C)
        return F.pad(e, (0, ceven[i] - C)) if ceven[i] != C else e

    # per bucket: the residuals (bf16: the bucket's [n, W] residual)
    bstate: List[Any] = [None] * len(buckets)

    def compress(b):
        idxs = buckets[b]
        if kind == "bf16":
            E = torch.cat([chunked(i) for i in idxs], dim=1)
            payload = E.to(torch.bfloat16)
            bstate[b] = E - payload.to(torch.float32)
        else:
            payload, bstate[b] = wp.quantize_bucket(
                [flat[i] for i in idxs], [steps[i] for i in idxs], n,
                widths[idxs[0]], nibs[idxs[0]])
        for i in idxs:
            _rec(rank, f"all_to_all.{'int4' if nibs[i] else kind}",
                 (n - 1) / n * (n * cols[i]) * item)
        if nibs[idxs[0]]:
            payload = wp.pack_chunks(payload)
        return payload

    a2a = _pipelined_collective(buckets, compress, rank.all_to_all)

    err2c: List[Any] = [None] * len(buckets)

    def requant(b):
        idxs = buckets[b]
        x = a2a[b]
        if nibs[idxs[0]]:
            x = unpack_nibbles(x, sum(ceven[i] for i in idxs), axis=-1)
        q2, err2c[b] = _phase2_requantize(_chunk_sum(x, kind), n, kind)
        if nibs[idxs[0]]:
            q2 = wp.pack_chunks(q2)
        for i in idxs:
            _rec(rank, f"all_gather.{'int4' if nibs[i] else kind}",
                 (n - 1) * cols[i] * q2.element_size())
        return q2

    gath = _pipelined_collective(buckets, requant, rank.all_gather)

    idx = rank.index
    out: List[Any] = [None] * N
    for b, idxs in enumerate(buckets):
        if kind != "bf16":
            pairs = wp.dequant_bucket(
                gath[b], err2c[b], bstate[b], [flat[i] for i in idxs],
                [steps[i] for i in idxs], n, idx, _phase2_shift(n),
                nibs[idxs[0]])
            for i, pair in zip(idxs, pairs):
                out[i] = pair
            continue
        dcat = true_div(gath[b].to(torch.float32), n)
        R, off = bstate[b], 0
        for i in idxs:
            _, _, T, C = dims[i]
            e = flat[i]
            ce = ceven[i]
            delivered = dcat[:, off:off + ce][:, :C].reshape(-1)[:T] \
                .reshape(e.shape).to(e.dtype)
            residual = R[:, off:off + ce][:, :C].reshape(-1)[:T] \
                .reshape(e.shape)
            scatter = _own_chunk(err2c[b][off:off + ce][:C], idx, n, C, T)
            out[i] = (delivered,
                      (residual + scatter.reshape(e.shape)).to(e.dtype))
            off += ce
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def ef_wire_init(grads: Any, n_data: int) -> Any:
    """Zero per-shard residual tree: each leaf gains a leading ``[n_data]``
    shard axis (``[1]`` per process on a ``ProcessGroupMesh``)."""
    return tree_map(lambda g: torch.zeros((n_data,) + tuple(g.shape),
                                          dtype=g.dtype, device=g.device),
                    grads)


def _check_kind(kind: str) -> None:
    if kind not in WIRE_KINDS:
        raise ValueError(f"unsupported wire compression kind {kind!r}; "
                         f"supported: {WIRE_KINDS}")


def _wire_pmean_impl(leaves: List[torch.Tensor], mesh, kind: str,
                     flags: Tuple[bool, ...], widths: Tuple[int, ...],
                     fused: bool, bucket_bytes: int
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    n = data_axis_size(mesh)
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != mesh.shards:
            raise ValueError(f"a leaf of shape {tuple(leaf.shape)} does not "
                             f"lead with the mesh's {mesh.shards} local "
                             f"shards")

    def body(rank, squeezed):
        if fused:
            return _wire_tree_fused(squeezed, rank, n, kind, flags, widths,
                                    bucket_bytes)
        return [_wire_leaf(leaf, rank, n, kind, st, b)
                for leaf, st, b in zip(squeezed, flags, widths)]

    outs = mesh.run(body, [[leaf[i] for leaf in leaves]
                           for i in range(mesh.shards)])
    delivered = [d for d, _ in outs[0]]      # replicated: every rank's same
    residual = [torch.stack([o[j][1] for o in outs])
                for j in range(len(leaves))]
    return delivered, residual


class _EFWirePmean(torch.autograd.Function):
    """Forward: the compressed mean; backward: each shard gets ``ct / n``,
    the transpose of an uncompressed shard mean (residual cotangents are
    dropped: state, not value)."""

    @staticmethod
    def forward(ctx, cfg, *leaves):
        delivered, residual = _wire_pmean_impl(list(leaves), *cfg)
        ctx.n = data_axis_size(cfg[0])
        ctx.lead = [leaf.shape[0] for leaf in leaves]
        ctx.mark_non_differentiable(*residual)
        return tuple(delivered) + tuple(residual)

    @staticmethod
    def backward(ctx, *cts):
        k = len(ctx.lead)
        grads = [None if ct is None else
                 true_div(ct, ctx.n)[None].expand((lead,) + tuple(ct.shape))
                 for ct, lead in zip(cts[:k], ctx.lead)]
        return (None, *grads)


def ef_wire_pmean(e_stacked: Any, mesh, kind: str = "int8",
                  stacked: Any = None, widths: Any = None,
                  fused: bool = True,
                  bucket_bytes: Optional[int] = None) -> Tuple[Any, Any]:
    """Compressed mean all-reduce with error feedback, inside the wire.

    ``e_stacked``: a tree whose leaves lead with the mesh's local shards
    (``[n]`` on a ``LocalMesh``, ``[1]`` on a ``ProcessGroupMesh``), each
    shard's ``local_grad + residual``.  Returns ``(delivered,
    new_residual)``: the mean gradient, the same on every rank, and the
    per-shard residual for the next step.

    ``stacked`` marks stacked-layer leaves (default: from the tree paths);
    ``widths`` carries per-leaf wire widths (``PrecisionPlan.
    wire_bits_tree``; ``None`` is uniform int8, <= 4 rides nibbles).
    ``fused`` selects the bucketed fast path, bit for bit the per-leaf
    one; ``bucket_bytes`` overrides the bucket budget (tests).
    Differentiable: the backward hands each shard ``ct / n``."""
    _check_kind(kind)
    bb = _WIRE_BUCKET_BYTES if bucket_bytes is None else int(bucket_bytes)
    leaves = tree_leaves(e_stacked)
    cfg = (mesh, kind, _stacked_flags(e_stacked, stacked),
           _width_flags(e_stacked, widths), bool(fused), bb)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        outs = _EFWirePmean.apply(cfg, *leaves)
    else:
        d, r = _wire_pmean_impl(leaves, *cfg)
        outs = d + r
    k = len(leaves)
    return (tree_unflatten(e_stacked, outs[:k]),
            tree_unflatten(e_stacked, outs[k:]))


def simulate_wire_pmean(e_stacked: Any, kind: str = "int8",
                        stacked: Any = None,
                        widths: Any = None) -> Tuple[Any, Any]:
    """Collective-free reference of :func:`ef_wire_pmean` on a stacked
    ``[n, ...]`` tree: the same grids, chunks and two-phase errors in one
    program (nibble packing is the identity on in-range mantissas, so it
    is not modelled)."""
    _check_kind(kind)
    flags = _stacked_flags(e_stacked, stacked)
    wflags = _width_flags(e_stacked, widths)

    def leaf(es, stk, bits):
        n = es.shape[0]
        dtype = es.dtype
        shape = es.shape[1:]
        L, Pn = _layer_rows(es[0], stk).shape
        amax = torch.amax(torch.abs(es.to(torch.float32).reshape(n, L, -1)),
                          dim=(0, 2))
        payloads, residuals, scale = [], [], None
        for i in range(n):
            p, scale, r = _phase1_quantize(es[i], amax, kind, stk, bits)
            payloads.append(p.reshape(-1))
            residuals.append(r)
        T = payloads[0].shape[0]
        C = -(-T // n)
        pad = n * C - T
        sums = _chunk_sum(torch.stack([F.pad(p, (0, pad))
                                       for p in payloads]), kind)
        s_flat = F.pad(scale[:, None].expand(L, Pn).reshape(-1), (0, pad),
                       value=1.0)
        q2, err2 = _phase2_requantize(sums.reshape(n, C), n, kind)
        q2 = q2.reshape(-1)
        if kind == "bf16":
            delivered_flat = true_div(q2.to(torch.float32), n)
            err2_val = err2
        else:
            delivered_flat = dequant_sum_ref(q2, s_flat, _phase2_shift(n), n)
            err2_val = err2 * s_flat.reshape(n, C)
        delivered = delivered_flat[:T].reshape(shape).to(dtype)
        new_res = torch.stack([
            (residuals[i] + _own_chunk(err2_val[i], i, n, C, T).reshape(shape))
            .to(dtype) for i in range(n)])
        return delivered, new_res

    flat = tree_leaves(e_stacked)
    pairs = [leaf(x, st, b) for x, st, b in zip(flat, flags, wflags)]
    return (tree_unflatten(e_stacked, [d for d, _ in pairs]),
            tree_unflatten(e_stacked, [r for _, r in pairs]))


def wire_bytes_model(n_elements: int, n: int, kind: str,
                     n_scale_rows: int = 1, bits: int = 8) -> float:
    """Analytic per-device bytes on the wire of one compressed mean-reduce
    of a leaf (what :class:`record_wire_bytes` records): all_to_all +
    all_gather of 1-byte / 2-byte / half-byte payloads plus the per-row
    float32 scale pmax."""
    _check_kind(kind)
    item = 1 if kind == "int8" else 2
    C = -(-n_elements // n)
    chunk_b = float(-(-C // 2)) if _nibble_wire(kind, bits) else C * item
    a2a = (n - 1) / n * (n * chunk_b)
    ag = (n - 1) * chunk_b
    scales = (_ring_allreduce_bytes(n_scale_rows * 4, n)
              if kind == "int8" else 0.0)
    return a2a + ag + scales


def fp32_allreduce_bytes(n_elements: int, n: int) -> float:
    """Per-device bytes of the ring float32 all-reduce the wire replaces."""
    return _ring_allreduce_bytes(n_elements * 4, n)
