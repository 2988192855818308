"""Compressed data-parallel gradient reduce: the reduction itself moves
int8 (or nibble, or bf16) bytes, not float32 (counterpart of
``repro/dist/collectives.py``).

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
``[n, ...]`` tree.  :func:`ef_wire_pmean_2d` (below) is the 2D
generalization over a ``data x model`` mesh: the exchange is sliced over
the ``model`` axis too, so each ``(data, model)`` rank reduces only its
1/(D*M) slice, and the model-axis replication moves int8 instead of
float32 (the section comment above it has the layout).
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
from .mesh import RECORDER
from .sharding import (_data_axes, _data_size, _mesh_sizes,
                       model_axis_for, stacked_tree)

WIRE_KINDS = ("int8", "bf16")

# fused-path bucket budget: wire payload bytes per pipelined buffer
_WIRE_BUCKET_BYTES = 1 << 20

class record_wire_bytes:
    """Context manager: collect (op, per-device payload bytes) tuples for
    every collective the wire reduce issues inside the block (one rank of
    a mesh records, as one trace does in the reference), and in
    ``collectives`` each collective that rank's mesh issues: (primitive,
    logical axes, dtype name, result shape), as ``analysis.collectives``
    reads them."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []
        self.collectives: List[Tuple[str, Tuple[str, ...], str,
                                     Tuple[int, ...]]] = []
        self._cm = None

    def collective(self, primitive: str, axes: Tuple[str, ...],
                   out: torch.Tensor) -> None:
        self.collectives.append((primitive, tuple(axes),
                                 str(out.dtype).replace("torch.", ""),
                                 tuple(out.shape)))

    def __enter__(self):
        self._cm = RECORDER.scope(self)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        cm, self._cm = self._cm, None
        return cm.__exit__(*exc)

    def total(self) -> float:
        return sum(b for _, b in self.records)


def _record(op: str, nbytes: float) -> None:
    rec = RECORDER.get()
    if rec is not None:
        rec.records.append((op, float(nbytes)))


def _rec(rank, op: str, nbytes: float) -> None:
    if rank.records:
        _record(op, nbytes)


def _ring_allreduce_bytes(nbytes: float, n: int) -> float:
    return 2.0 * (n - 1) / n * nbytes


def data_axis_names(mesh) -> Tuple[str, ...]:
    """The data-parallel axis names of ``mesh`` (pod is outer data
    parallelism; the axis list lives once, in ``sharding``)."""
    return _data_axes(mesh)


def data_axis_size(mesh) -> int:
    """Data ranks of ``mesh`` (1 for ``None``)."""
    return _data_size(mesh)


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
    idx = rank.data_index
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

    idx = rank.data_index
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

    # on a model axis every model rank of a data shard runs the exchange
    # over the data axis on the whole gradient (the reference's shard_map
    # leaves model unmapped); the first local model rank keeps the residual
    ranks = mesh.local_ranks
    outs = mesh.run(body, [[leaf[d] for leaf in leaves] for d, _ in ranks])
    delivered = [d for d, _ in outs[0]]      # replicated: every rank's same
    residual = [torch.stack([o[j][1] for o, (_, m) in zip(outs, ranks)
                             if m == ranks[0][1]])
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


# ---------------------------------------------------------------------------
# 2D (data x model) sliced wire collective
# ---------------------------------------------------------------------------
#
# The 1D exchange above replicates over the model axis: every model rank
# exchanges and reduces the whole gradient (and, under tensor parallelism,
# first pays a float32 all_gather over `model` to rematerialize it).  The
# 2D exchange slices it over `model` too:
#
#   * rank (d, m) takes its block of each gradient leaf: the model block
#     on the tensor axis its placement spec shards over `model`
#     (`sharding.model_axis_for`, the rule of `spec_for_param`), in the
#     block's row-major order; a leaf that does not shard over `model` is
#     flat-sliced by model index instead (padded to M * Cp);
#   * the two-phase int8 all_to_all + all_gather reduce runs over the data
#     axis on that slice only (1/M the bytes), on per-row 2^-f grids whose
#     amax the pmax shares over BOTH axes, so the int32 sums stay exact;
#   * one all_gather over `model` rematerializes each rank's whole
#     delivered gradient from the quantized sums (decoded once, after it);
#   * the residuals live in the sliced layout, a [n_data, n_model, C] stack
#     (`ef_wire2d_init`), rank (d, m) owning [d, m]; both phases' errors
#     stay in the slice, so the delivered mean telescopes as in 1D.
#
# Per-device payload bytes per gradient element (D data x M model):
#   1D:  (M-1)/M * 4 (float32 model gather)  +  2 (D-1)/D * 1  (int8)
#   2D:  2 (D-1)/(D*M) * 1                   +  (M-1)/M * 1    (int8)
# e.g. on a 2 x 4 mesh: 4.0 B per element -> 1.0.

def model_axis_size(mesh) -> int:
    """Size of the mesh's tensor-parallel ``model`` axis (1 if absent or
    for ``None``)."""
    return int(_mesh_sizes(mesh).get("model", 1))


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def wire2d_slice_len(shape, n_data: int, n_model: int) -> int:
    """Padded flat slice length ``C`` each ``(data, model)`` rank owns for
    a leaf of ``shape``: the model block (when the leaf shards over
    ``model``) or the ceil-div flat slice, padded up to a multiple of
    ``n_data`` so the data all_to_all chunks evenly."""
    T = _prod(shape)
    if model_axis_for(shape, n_model) is not None:
        Tb = T // n_model
    else:
        Tb = -(-T // n_model)
    return n_data * (-(-Tb // n_data))


def ef_wire2d_init(grads: Any, n_data: int, n_model: int) -> Any:
    """Zero residual tree in the 2D sliced layout: each leaf becomes a
    flat ``[n_data, n_model, C]`` stack (``C`` from :func:`wire2d_slice_len`;
    ``[1, 1, C]`` per process on a ``ProcessGroupMesh``).  A mesh rescale
    changes ``C`` (or the leading axes), so a checkpointed residual from
    another mesh fails to restore into this template: callers warn and
    restart it at zero."""
    return tree_map(lambda g: torch.zeros(
        (n_data, n_model, wire2d_slice_len(g.shape, n_data, n_model)),
        dtype=g.dtype, device=g.device), grads)


def _wire2d_rows(shape, stacked: bool) -> Tuple[int, int]:
    """(L, row_len) of a leaf: one quantization row per stacked-layer entry
    for stacked rank >= 3 leaves, one per tensor otherwise (the rule of
    :func:`_layer_rows`)."""
    L = int(shape[0]) if (stacked and len(shape) >= 3) else 1
    return L, _prod(shape) // max(L, 1)


def _split_cols(buf: torch.Tensor, idxs, cols) -> dict:
    """Undo a column concatenation along the last axis: per-leaf slices."""
    out, off = {}, 0
    for i in idxs:
        out[i] = buf[..., off:off + cols[i]]
        off += cols[i]
    return out


def _wire2d_slice(g: torch.Tensor, k: Optional[int], D: int, M: int,
                  m: int, stacked: bool) -> dict:
    """Rank ``(., m)``'s slice of one data shard's gradient leaf ``g``:
    ``sl`` the padded float32 [Cp] slice, ``row_of`` each position's grid
    row (``None`` for a leaf of one row), and the sizes (``L``,
    ``Prow_full``, ``C``, ``Cp``, ``Tb``, the block shape ``B``)."""
    S = tuple(g.shape)
    L, Prow_full = _wire2d_rows(S, stacked)
    dev = g.device
    if k is not None:
        Bk = S[k] // M
        blk = g.narrow(k, m * Bk, Bk)
        B = tuple(blk.shape)
        Tb = blk.numel()
        C = -(-Tb // D)
        Cp = D * C
        sl = F.pad(blk.to(torch.float32).reshape(-1), (0, Cp - Tb))
        row_of = None if L == 1 else torch.clamp(
            torch.arange(Cp, device=dev) // (Tb // L), max=L - 1)
    else:
        T = g.numel()
        Tb = -(-T // M)
        C = -(-Tb // D)
        Cp = D * C
        B = S
        # the slice [m Cp, (m + 1) Cp) of the leaf padded to M Cp
        part = g.to(torch.float32).reshape(-1)[m * Cp:(m + 1) * Cp]
        sl = F.pad(part, (0, Cp - part.numel()))
        row_of = None if L == 1 else torch.clamp(
            (m * Cp + torch.arange(Cp, device=dev)) // Prow_full, max=L - 1)
    return dict(sl=sl, row_of=row_of, L=L, Prow_full=Prow_full, C=C, Cp=Cp,
                Tb=Tb, B=B)


def _row_amax(e: torch.Tensor, row_of: Optional[torch.Tensor], L: int
              ) -> torch.Tensor:
    """Per-row max of ``|e|`` over the rows ``row_of`` names ([L], 0 where a
    row has no position; one row where ``row_of`` is ``None``)."""
    if row_of is None:
        return torch.amax(torch.abs(e)).reshape(1)
    return torch.zeros((L,), dtype=torch.float32, device=e.device) \
        .scatter_reduce(0, row_of, torch.abs(e), "amax")


def _at_rows(scale: torch.Tensor, row_of: Optional[torch.Tensor], n: int
             ) -> torch.Tensor:
    """The grid step of each of ``n`` positions: ``scale[row_of]``, or the
    one row's step broadcast."""
    return scale.expand(n) if row_of is None else scale[row_of]


def _wire2d_deliver(dec: torch.Tensor, inf: dict, S, k: Optional[int]
                    ) -> torch.Tensor:
    """The decoded model gather (``[M, Cp]``) back into the leaf's shape:
    the model blocks concatenated along ``k``, or the flat slices in
    order."""
    if k is not None:
        blocks = dec[:, :inf["Tb"]].reshape((dec.shape[0],) + inf["B"])
        return torch.cat(list(blocks), dim=k)
    return dec.reshape(-1)[:_prod(S)].reshape(S)


def _wire2d_finish(rank, inf: dict, gath: torch.Tensor, s_sl, scale, res1,
                   err2, S, k: Optional[int], D: int, kind: str, dtypes,
                   dequant) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One leaf's end on one rank: the decode of the model gather ``gath``
    ([M, Cp] sums; ``dequant`` is ``wire_pack.dequant_sum`` or its plain
    version) into the delivered mean, on a delivering rank only, and the
    phase-2 error feedback: the chunk owner keeps the shift remainder in
    its own slice, as in 1D.  ``dtypes``: (delivered, residual)."""
    delivered = None
    if not rank.delivers:
        pass
    elif kind == "bf16":
        delivered = true_div(gath.to(torch.float32), D)
    elif k is not None:
        delivered = dequant(gath, s_sl[None], _phase2_shift(D), D)
    else:
        flat_q = gath.reshape(-1)
        row_full = None if inf["L"] == 1 else torch.clamp(
            torch.arange(flat_q.shape[0], device=flat_q.device)
            // inf["Prow_full"], max=inf["L"] - 1)
        delivered = dequant(flat_q, _at_rows(scale, row_full,
                                             flat_q.shape[0]),
                            _phase2_shift(D), D)
    if delivered is not None:
        delivered = _wire2d_deliver(delivered.reshape(gath.shape), inf, S,
                                    k).to(dtypes[0])
    C, didx = inf["C"], rank.data_index
    err2_val = err2 if kind == "bf16" else err2 * s_sl[didx * C:
                                                        (didx + 1) * C]
    new_r = res1 + _own_chunk(err2_val, didx, D, C, inf["Cp"])
    return delivered, new_r.to(dtypes[1])


def _wire2d_leaf(g: torch.Tensor, r: torch.Tensor, k: Optional[int],
                 rank, D: int, M: int, kind: str, stacked: bool,
                 bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliced compressed mean-reduce of one leaf on one rank, in plain
    PyTorch: the executable reference of the fused path.  ``g`` is this
    rank's data shard's gradient leaf, ``r`` its ``[Cp]`` residual slice;
    returns (the delivered mean, the new residual slice).  ``bits`` <= 4
    nibble-packs every payload (all three collectives).  A rank that does
    not deliver (``rank.delivers``) returns ``None`` for the mean."""
    S = tuple(g.shape)
    inf = _wire2d_slice(g, k, D, M, rank.model_index, stacked)
    L, C, Cp, row_of = inf["L"], inf["C"], inf["Cp"], inf["row_of"]
    e = inf["sl"] + r.to(torch.float32)

    scale = None
    if kind == "bf16":
        s_sl = torch.ones((Cp,), dtype=torch.float32, device=e.device)
        payload = e.to(torch.bfloat16)
        res1 = e - payload.to(torch.float32)
    else:
        # the 2D pmax makes the grid global: every (data, model) slice
        # quantizes on it, the int32 chunk sums stay exact
        amax = rank.pmax(_row_amax(e, row_of, L))
        _rec(rank, "pmax.scale", _ring_allreduce_bytes(L * 4, D * M))
        scale = wp.grid_scale(amax, bits)
        s_sl = _at_rows(scale, row_of, Cp)
        payload, res1 = wp.ref.quantize_chunks_ref(e, s_sl, bits)

    nib = _nibble_wire(kind, bits)
    wtag = "int4" if nib else kind
    item = payload.element_size()
    # phase 1: reduce-scatter the slice over data as all_to_all
    if D > 1:
        if nib:
            pk = pack_nibbles(payload.reshape(D, C), axis=-1)
            _rec(rank, f"all_to_all.{wtag}",
                 (D - 1) / D * (D * pk.shape[-1]) * pk.element_size())
            ex = unpack_nibbles(rank.all_to_all(pk), C, axis=-1)
        else:
            _rec(rank, f"all_to_all.{wtag}", (D - 1) / D * Cp * item)
            ex = rank.all_to_all(payload.reshape(D, C))
        chunk_sum = _chunk_sum(ex, kind)
    else:
        chunk_sum = payload.to(torch.float32 if kind == "bf16"
                               else torch.int32)

    # phase 2: requantize the owned chunk, gather the slice over data
    q2, err2 = _phase2_requantize(chunk_sum, D, kind)
    if D > 1:
        if nib:
            q2p = pack_nibbles(q2, axis=-1)
            _rec(rank, f"all_gather.{wtag}",
                 (D - 1) * q2p.shape[0] * q2p.element_size())
            sl_q = unpack_nibbles(rank.all_gather(q2p), C,
                                  axis=-1).reshape(Cp)
        else:
            _rec(rank, f"all_gather.{wtag}", (D - 1) * C * q2.element_size())
            sl_q = rank.all_gather(q2).reshape(Cp)
    else:
        sl_q = q2.reshape(Cp)

    # phase 3: rematerialize over model; the quantized sums cross the model
    # axis, decoded once after the gather
    if M > 1:
        if nib:
            slp = pack_nibbles(sl_q, axis=-1)
            _rec(rank, f"all_gather.{wtag}.model",
                 (M - 1) * slp.shape[0] * slp.element_size())
            gath = unpack_nibbles(rank.all_gather(slp, axis="model"), Cp,
                                  axis=-1)
        else:
            _rec(rank, f"all_gather.{wtag}.model",
                 (M - 1) * Cp * sl_q.element_size())
            gath = rank.all_gather(sl_q, axis="model")
    else:
        gath = sl_q[None]
    return _wire2d_finish(rank, inf, gath, s_sl, scale, res1, err2, S, k, D,
                          kind, (g.dtype, r.dtype), dequant_sum_ref)


def _wire2d_tree_fused(gflat: List[torch.Tensor], rflat: List[torch.Tensor],
                       ks, rank, D: int, M: int, kind: str,
                       flags: Tuple[bool, ...], widths: Tuple[int, ...],
                       bucket_bytes: int
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The fused twin of mapping :func:`_wire2d_leaf` over a tree, bit for
    bit: one 2D amax ``pmax`` for every leaf, the ``wire_pack`` kernels for
    phase 1 (``quantize_chunks``: ``wire_quantize_sflat`` on the [D, C]
    slice), the nibble packs (``wire_pack_rows``) and the decode
    (``dequant_sum``: ``wire_dequant_rows`` on the gathered [M, Cp] or
    [M * Cp]), and all three exchanges (data all_to_all, data all_gather,
    model all_gather) pipelined over size-bucketed, column-concatenated
    buffers.  Byte records keep the per-leaf tags and values (no data
    exchange records when D == 1).  A rank that does not deliver
    (``rank.delivers``) joins every exchange but decodes nothing (``None``
    for each mean)."""
    N = len(gflat)
    m = rank.model_index
    info = []
    for g, r, k, st in zip(gflat, rflat, ks, flags):
        inf = _wire2d_slice(g, k, D, M, m, st)
        inf["e"] = inf.pop("sl") + r.to(torch.float32)
        info.append(inf)

    scales: List[Optional[torch.Tensor]] = [None] * N
    if kind != "bf16":
        gmax = rank.pmax(torch.cat([_row_amax(inf["e"], inf["row_of"],
                                              inf["L"]) for inf in info]))
        # grid_scale is elementwise: one call a width over the whole pmax
        by_width = {w: wp.grid_scale(gmax, w) for w in sorted(set(widths))}
        off = 0
        for i, inf in enumerate(info):
            L = inf["L"]
            scales[i] = by_width[widths[i]][off:off + L]
            off += L
            _rec(rank, "pmax.scale", _ring_allreduce_bytes(L * 4, D * M))

    nibs = [_nibble_wire(kind, w) for w in widths]
    item = 2 if kind == "bf16" else 1
    cols = [(-(-inf["C"] // 2) if nib else inf["C"])
            for inf, nib in zip(info, nibs)]
    buckets = _bucket_leaves([D * c * item for c in cols], bucket_bytes)
    acc_t = torch.float32 if kind == "bf16" else torch.int32
    state: List[Any] = [None] * N

    def compress(i):
        """Leaf i's slice -> payload [D, C] in the wire dtype."""
        inf = info[i]
        C = inf["C"]
        if kind == "bf16":
            s_sl = torch.ones((inf["Cp"],), dtype=torch.float32,
                              device=inf["e"].device)
            payload = inf["e"].to(torch.bfloat16)
            res1 = inf["e"] - payload.to(torch.float32)
            payload = payload.reshape(D, C)
        else:
            s_sl = _at_rows(scales[i], inf["row_of"], inf["Cp"])
            payload, res = wp.quantize_chunks(
                inf["e"].reshape(D, C), s_sl.reshape(D, C), widths[i])
            res1 = res.reshape(-1)
        state[i] = (s_sl, res1)
        return payload

    err2s: List[Any] = [None] * N
    slq: List[Any] = [None] * N
    if D > 1:
        def build1(b):
            parts = []
            for i in buckets[b]:
                p = compress(i)
                wtag = "int4" if nibs[i] else kind
                if nibs[i]:
                    p = wp.pack_chunks(p)
                    _rec(rank, f"all_to_all.{wtag}", (D - 1) / D
                         * (D * p.shape[-1]) * p.element_size())
                else:
                    _rec(rank, f"all_to_all.{wtag}",
                         (D - 1) / D * info[i]["Cp"] * p.element_size())
                parts.append(p)
            return torch.cat(parts, dim=1)

        a2a = _pipelined_collective(buckets, build1, rank.all_to_all)
        ex: dict = {}
        for b, bucket in enumerate(buckets):
            ex.update(_split_cols(a2a[b], bucket, cols))

        def build2(b):
            parts = []
            for i in buckets[b]:
                x = ex[i]
                if nibs[i]:
                    x = unpack_nibbles(x, info[i]["C"], axis=-1)
                q2, err2s[i] = _phase2_requantize(
                    x.to(acc_t).sum(dim=0), D, kind)
                wtag = "int4" if nibs[i] else kind
                if nibs[i]:
                    q2 = wp.pack_chunks(q2)
                _rec(rank, f"all_gather.{wtag}",
                     (D - 1) * q2.shape[0] * q2.element_size())
                parts.append(q2)
            return torch.cat(parts)

        gath2 = _pipelined_collective(buckets, build2, rank.all_gather)
        for b, bucket in enumerate(buckets):
            for i, f in _split_cols(gath2[b], bucket, cols).items():
                if nibs[i]:
                    f = unpack_nibbles(f, info[i]["C"], axis=-1)
                slq[i] = f.reshape(info[i]["Cp"])
    else:
        for i in range(N):
            q2, err2s[i] = _phase2_requantize(
                compress(i).reshape(-1).to(acc_t), D, kind)
            slq[i] = q2.reshape(info[i]["Cp"])

    gth: List[Any] = [None] * N
    if M > 1:
        mcols = [(-(-inf["Cp"] // 2) if nib else inf["Cp"])
                 for inf, nib in zip(info, nibs)]

        def build3(b):
            parts = []
            for i in buckets[b]:
                mg = slq[i]
                wtag = "int4" if nibs[i] else kind
                if nibs[i]:
                    mg = wp.pack_chunks(mg)
                _rec(rank, f"all_gather.{wtag}.model",
                     (M - 1) * mg.shape[0] * mg.element_size())
                parts.append(mg)
            return torch.cat(parts)

        gath3 = _pipelined_collective(
            buckets, build3, lambda x: rank.all_gather(x, axis="model"))
        for b, bucket in enumerate(buckets):
            for i, f in _split_cols(gath3[b], bucket, mcols).items():
                gth[i] = (unpack_nibbles(f, info[i]["Cp"], axis=-1)
                          if nibs[i] else f)
    else:
        gth = [q[None] for q in slq]

    return [_wire2d_finish(rank, info[i], gth[i], state[i][0], scales[i],
                           state[i][1], err2s[i], tuple(g.shape), k, D, kind,
                           (g.dtype, r.dtype), wp.dequant_sum)
            for i, (g, r, k) in enumerate(zip(gflat, rflat, ks))]


def _wire2d_impl(gleaves: List[torch.Tensor], rleaves: List[torch.Tensor],
                 mesh, kind: str, flags: Tuple[bool, ...],
                 widths: Tuple[int, ...], fused: bool, bucket_bytes: int
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    D, M = data_axis_size(mesh), model_axis_size(mesh)
    ranks = mesh.local_ranks
    n_model_local = len({m for _, m in ranks})
    # rank slicing follows the placement rule of ``spec_for_param``: the
    # tensor axis that carries "model" (the shard axis 0 aside)
    ks = [model_axis_for(tuple(g.shape[1:]), M) for g in gleaves]
    for g, r in zip(gleaves, rleaves):
        want = (mesh.shards, n_model_local,
                wire2d_slice_len(g.shape[1:], D, M))
        if g.ndim < 1 or g.shape[0] != mesh.shards or tuple(r.shape) != want:
            raise ValueError(
                f"a gradient leaf of shape {tuple(g.shape)} with a residual "
                f"of {tuple(r.shape)}: the mesh's {mesh.shards} local data "
                f"shards and a residual of {want} expected")

    def body(rank, arg):
        gs, rs = arg
        if fused:
            return _wire2d_tree_fused(gs, rs, ks, rank, D, M, kind, flags,
                                      widths, bucket_bytes)
        return [_wire2d_leaf(g, r, k, rank, D, M, kind, st, b)
                for g, r, k, st, b in zip(gs, rs, ks, flags, widths)]

    mi = {m: j for j, m in enumerate(sorted({m for _, m in ranks}))}
    outs = mesh.run(body, [([g[d] for g in gleaves],
                            [r[d, mi[m]] for r in rleaves])
                           for d, m in ranks])
    # replicated: the first local rank delivers (a LocalMesh's rank 0)
    delivered = [dl for dl, _ in outs[0]]
    residual = []
    for j, r in enumerate(rleaves):
        new = torch.empty_like(r)
        for o, (d, m) in zip(outs, ranks):
            new[d, mi[m]] = o[j][1]
        residual.append(new)
    return delivered, residual


class _EFWirePmean2D(torch.autograd.Function):
    """Forward: the 2D compressed mean; backward: each data shard gets
    ``ct / n_data``, the transpose of an uncompressed shard mean, and the
    residual a zero cotangent (state, not value)."""

    @staticmethod
    def forward(ctx, cfg, n_leaves, *leaves):
        g, r = list(leaves[:n_leaves]), list(leaves[n_leaves:])
        delivered, residual = _wire2d_impl(g, r, *cfg)
        ctx.n = data_axis_size(cfg[0])
        ctx.lead = [x.shape[0] for x in g]
        ctx.res_shapes = [(tuple(x.shape), x.dtype, x.device) for x in r]
        ctx.mark_non_differentiable(*residual)
        return tuple(delivered) + tuple(residual)

    @staticmethod
    def backward(ctx, *cts):
        k = len(ctx.lead)
        grads = [None if ct is None else
                 true_div(ct, ctx.n)[None].expand((lead,) + tuple(ct.shape))
                 for ct, lead in zip(cts[:k], ctx.lead)]
        zeros = [torch.zeros(s, dtype=dt, device=dv)
                 for s, dt, dv in ctx.res_shapes]
        return (None, None, *grads, *zeros)


def ef_wire_pmean_2d(grads_stacked: Any, residual: Any, mesh,
                     kind: str = "int8", stacked: Any = None,
                     widths: Any = None, fused: bool = True,
                     bucket_bytes: Optional[int] = None
                     ) -> Tuple[Any, Any]:
    """2D-sliced compressed mean all-reduce with error feedback over a
    ``data x model`` mesh.

    ``grads_stacked``: a tree whose leaves lead with the mesh's local data
    shards (``[n_data]`` on a ``LocalMesh``, ``[1]`` on a
    ``ProcessGroupMesh``), each shard's local gradient, not yet added to
    the residual (the add happens on the slice, inside the exchange);
    ``residual``: the matching ``[n_data, n_model, C]`` tree of
    :func:`ef_wire2d_init` (``[1, 1, C]`` per process).  Returns
    ``(delivered, new_residual)``: the mean gradient, the same on every
    rank, and the sliced residual for the next step.  ``stacked``,
    ``widths``, ``fused`` and ``bucket_bytes`` as in :func:`ef_wire_pmean`
    (the fused path is bit for bit the per-leaf one).  Differentiable in
    ``grads_stacked``: each shard gets ``ct / n_data``."""
    _check_kind(kind)
    bb = _WIRE_BUCKET_BYTES if bucket_bytes is None else int(bucket_bytes)
    gleaves, rleaves = tree_leaves(grads_stacked), tree_leaves(residual)
    if len(gleaves) != len(rleaves):
        raise ValueError(f"{len(gleaves)} gradient leaves, "
                         f"{len(rleaves)} residual leaves")
    cfg = (mesh, kind, _stacked_flags(grads_stacked, stacked),
           _width_flags(grads_stacked, widths), bool(fused), bb)
    if torch.is_grad_enabled() and any(x.requires_grad for x in gleaves):
        outs = _EFWirePmean2D.apply(cfg, len(gleaves), *gleaves, *rleaves)
    else:
        d, r = _wire2d_impl(gleaves, rleaves, *cfg)
        outs = d + r
    k = len(gleaves)
    return (tree_unflatten(grads_stacked, outs[:k]),
            tree_unflatten(residual, outs[k:]))


def simulate_wire_pmean_2d(grads_stacked: Any, residual: Any, n_model: int,
                           kind: str = "int8", stacked: Any = None,
                           widths: Any = None) -> Tuple[Any, Any]:
    """Collective-free reference of :func:`ef_wire_pmean_2d` on a stacked
    ``[n_data, ...]`` gradient tree and its ``[n_data, n_model, C]``
    residual: the same slicing, grids, chunks and two-phase errors in one
    program (nibble packing is the identity on in-range mantissas, so it is
    not modelled)."""
    _check_kind(kind)
    flags = _stacked_flags(grads_stacked, stacked)
    wflags = _width_flags(grads_stacked, widths)

    def leaf(es, res, stk, bits):
        D, M = es.shape[0], n_model
        S = tuple(es.shape[1:])
        dtype = es.dtype
        L, _ = _wire2d_rows(S, stk)
        k = model_axis_for(S, M)
        Cp = res.shape[-1]
        C = Cp // D
        shift = _phase2_shift(D)
        sl = [[_wire2d_slice(es[d], k, D, M, m, stk) for m in range(M)]
              for d in range(D)]
        rows = [sl[0][m]["row_of"] for m in range(M)]
        es_sl = [[sl[d][m]["sl"] + res[d, m].to(torch.float32)
                  for m in range(M)] for d in range(D)]
        if kind != "bf16":
            local = [_row_amax(es_sl[d][m], rows[m], L)
                     for d in range(D) for m in range(M)]
            scale = wp.grid_scale(torch.amax(torch.stack(local), dim=0),
                                  bits)
        delivered_slices = [None] * M
        new_res = [[None] * M for _ in range(D)]
        for m in range(M):
            if kind == "bf16":
                s_sl = torch.ones((Cp,), dtype=torch.float32,
                                  device=es.device)
                payloads = [es_sl[d][m].to(torch.bfloat16) for d in range(D)]
                res1 = [es_sl[d][m] - payloads[d].to(torch.float32)
                        for d in range(D)]
            else:
                s_sl = _at_rows(scale, rows[m], Cp)
                pr = [wp.ref.quantize_chunks_ref(es_sl[d][m], s_sl, bits)
                      for d in range(D)]
                payloads = [p for p, _ in pr]
                res1 = [r1 for _, r1 in pr]
            sums = _chunk_sum(torch.stack([p.reshape(D, C)
                                           for p in payloads]), kind)
            q2, err2 = _phase2_requantize(sums, D, kind)
            sl_q = q2.reshape(Cp)
            delivered_slices[m] = (true_div(sl_q.to(torch.float32), D)
                                   if kind == "bf16" else
                                   dequant_sum_ref(sl_q, s_sl, shift, D))
            for d in range(D):
                err_val = (err2[d] if kind == "bf16"
                           else err2[d] * s_sl[d * C:(d + 1) * C])
                new_res[d][m] = (res1[d] + _own_chunk(err_val, d, D, C, Cp)
                                 ).to(res.dtype)
        delivered = _wire2d_deliver(torch.stack(delivered_slices), sl[0][0],
                                    S, k)
        nr = torch.stack([torch.stack(new_res[d]) for d in range(D)])
        return delivered.to(dtype), nr

    pairs = [leaf(g, r, st, b) for g, r, st, b in zip(
        tree_leaves(grads_stacked), tree_leaves(residual), flags, wflags)]
    return (tree_unflatten(grads_stacked, [d for d, _ in pairs]),
            tree_unflatten(residual, [r for _, r in pairs]))


def wire2d_leaf_bytes(shape, n_data: int, n_model: int, kind: str,
                      stacked: bool = False, bits: int = 8) -> float:
    """Analytic per-device wire bytes of one 2D-sliced mean-reduce of a
    leaf (what :class:`record_wire_bytes` records, at the leaf's wire
    width): the data all_to_all and all_gather on the 1/M slice, the
    quantized model-axis all_gather, and the per-row scale pmax over all
    D * M ranks."""
    _check_kind(kind)
    item = 1 if kind == "int8" else 2
    Cp = wire2d_slice_len(shape, n_data, n_model)
    C = Cp // n_data
    if _nibble_wire(kind, bits):
        chunk_b, slice_b = float(-(-C // 2)), float(-(-Cp // 2))
    else:
        chunk_b, slice_b = C * item, Cp * item
    a2a = (n_data - 1) * chunk_b if n_data > 1 else 0.0
    ag = (n_data - 1) * chunk_b if n_data > 1 else 0.0
    ag_model = (n_model - 1) * slice_b if n_model > 1 else 0.0
    L, _ = _wire2d_rows(shape, stacked)
    scales = (_ring_allreduce_bytes(L * 4, n_data * n_model)
              if kind == "int8" else 0.0)
    return a2a + ag + ag_model + scales


def tp_replication_bytes(shape, n_model: int) -> float:
    """Per-device float32 bytes the 1D exchange pays on a tensor-parallel
    mesh to rematerialize a model-sharded gradient leaf before its
    model-replicated reduce (an all_gather over ``model``): zero when the
    leaf does not shard over ``model``, and zero for the 2D exchange, whose
    slices are the sharded gradient."""
    if n_model <= 1 or model_axis_for(shape, n_model) is None:
        return 0.0
    return (n_model - 1) * (_prod(shape) / n_model) * 4.0
