"""Parameter, batch and cache placement rules, FSDP x TP (counterpart of
``repro/dist/sharding.py``).

One heuristic, applied uniformly to every parameter leaf by
:func:`spec_for_param`:

* only the trailing two axes of a weight are sharding candidates: any
  leading axes (the stacked-layer axis, MoE expert axes, conv spatial
  dims) are iterated per step or routed per token;
* the larger trailing axis goes to the tensor-parallel ``model`` axis,
  the other to the data-parallel axes (FSDP); in ``mode="serve"`` only
  the TP shard is kept;
* an axis that does not divide the mesh axis size replicates instead.

Data-parallel axes are ``("data",)`` on the port's meshes and ``("pod",
"data")`` on a multi-pod mesh: ``pod`` is outer data parallelism, so
batch and FSDP shards span both.

A placement is the port's own :class:`PartitionSpec` (one entry per
tensor axis: ``None``, an axis name or a tuple of axis names, the entries
of JAX's ``PartitionSpec``) over a mesh, a :class:`NamedSharding`.  The
mesh is anything with ``axis_names`` and ``axis_sizes`` (``dist.
LocalMesh``, ``dist.ProcessGroupMesh``); ``None`` is the 1 x 1 mesh.  On
one card the forward and backward of each data shard run unsharded, so
nothing moves a tensor to its placement: the 2D exchange slices by the
rule the specs place "model" by (``model_axis_for``, which
``collectives.ef_wire_pmean_2d`` reads), and ``RunContext.train_shardings``
reports them.  DTensor would place them across processes, one rank each, and
NCCL refuses two ranks on one GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from ..tree import tree_flatten_with_path, tree_map, tree_unflatten
from .mesh import AXIS_NAMES

_DATA_AXIS_NAMES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor axis: ``None`` (replicated), an axis name, or a
    tuple of axis names (a one-name tuple is that name, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a mesh (a tree leaf, not a container)."""
    mesh: Any
    spec: PartitionSpec


def _axes_of(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if mesh is None:
        return AXIS_NAMES, (1, 1)
    return tuple(mesh.axis_names), tuple(int(s) for s in mesh.axis_sizes)


def _mesh_sizes(mesh) -> dict:
    return dict(zip(*_axes_of(mesh)))


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axes_of(mesh)[0] if a in _DATA_AXIS_NAMES)


def _data_size(mesh) -> int:
    sizes = _mesh_sizes(mesh)
    n = 1
    for a in _data_axes(mesh):
        n *= sizes[a]
    return n


# tree containers whose children carry a leading stacked-layer axis: the
# layer stacks and the MoE expert stacks.  The tree path, not the rank,
# says whether a leaf is stacked: a genuinely 3-D weight (a per-head
# attention tensor) is one tensor.
STACKED_CONTAINERS = frozenset({
    "layers", "units", "blocks", "dec_layers", "enc_layers",
    "down", "gate", "up",  # HMoE per-expert [E, ...] weight stacks
})


def is_stacked_path(path: Sequence[Any]) -> bool:
    """True when a tree path passes through a stacked-layer container,
    i.e. the leaf's leading axis is a layer (or expert) axis."""
    return any(str(k) in STACKED_CONTAINERS for k in path)


def stacked_tree(tree: Any) -> Any:
    """A matching tree of bools marking the leaves with a leading
    stacked-layer axis (per-layer quantization grids in ``ef_compress``
    and the wire collectives)."""
    return tree_unflatten(tree, [is_stacked_path(path) for path, _ in
                                 tree_flatten_with_path(tree)])


def model_axis_for(shape: Sequence[int], model_size: int) -> Optional[int]:
    """The tensor axis a ``model`` mesh axis of ``model_size`` shards, or
    ``None`` when the leaf replicates: the larger of the two trailing axes
    (axis -1 wins ties), only when it divides ``model_size``; rank < 2
    leaves always replicate.  One rule for :func:`spec_for_param`, the 2D
    exchange's rank slicing and its simulator."""
    shape = tuple(shape)
    if len(shape) < 2 or model_size <= 1:
        return None
    model_pos = len(shape) - 1 if shape[-1] >= shape[-2] else len(shape) - 2
    return model_pos if shape[model_pos] % model_size == 0 else None


def spec_for_param(path: Sequence[Any], shape: Sequence[int], mesh,
                   mode: str = "train") -> PartitionSpec:
    """Placement spec for one parameter leaf of ``shape`` (``path``, its
    tree path, is not read: one rule for every leaf); ``mode`` is
    ``"train"`` (FSDP x TP) or ``"serve"`` (TP only)."""
    del path
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    shape = tuple(shape)
    if len(shape) < 2:
        return P(*([None] * len(shape)))
    model_size = _mesh_sizes(mesh).get("model", 1)
    daxes = _data_axes(mesh)
    dsize = _data_size(mesh)
    entries: list = [None] * len(shape)
    # larger trailing axis -> model; axis -1 wins ties; the other -> data
    model_pos = len(shape) - 1 if shape[-1] >= shape[-2] else len(shape) - 2
    data_pos = len(shape) - 2 if model_pos == len(shape) - 1 \
        else len(shape) - 1
    if model_axis_for(shape, model_size) is not None:
        entries[model_pos] = "model"
    if mode == "train" and dsize > 1 and shape[data_pos] % dsize == 0:
        entries[data_pos] = daxes if len(daxes) > 1 else daxes[0]
    return P(*entries)


def batch_spec(mesh, batch: int, ndim: int) -> PartitionSpec:
    """Leading-axis data sharding for a batch of ``ndim`` dims; replicate
    when the global batch does not fill every data shard."""
    daxes = _data_axes(mesh)
    dsize = _data_size(mesh)
    entries: list = [None] * ndim
    if dsize > 1 and batch > 1 and batch % dsize == 0:
        entries[0] = daxes
    return P(*entries)


def batch_sharding(mesh, batch: int, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh, batch, ndim))


def cache_sharding(mesh, shape: Sequence[int], *, batch_axis: int = 1,
                   seq_axis: Optional[int] = None,
                   head_axis: Optional[int] = None) -> NamedSharding:
    """Decode-cache placement: batch over data, heads (or, failing that,
    the sequence / window axis) over model.  Axis 0 is the stacked-layer
    axis and always replicates."""
    shape = tuple(shape)
    model_size = _mesh_sizes(mesh).get("model", 1)
    daxes = _data_axes(mesh)
    dsize = _data_size(mesh)
    entries: list = [None] * len(shape)
    if dsize > 1 and shape[batch_axis] % dsize == 0:
        entries[batch_axis] = daxes if len(daxes) > 1 else daxes[0]
    if model_size > 1:
        for ax in (head_axis, seq_axis):
            if ax is not None and shape[ax] % model_size == 0:
                entries[ax] = "model"
                break
    return NamedSharding(mesh, P(*entries))


def ef_residual_sharding(tree: Any, mesh, layout: str = "1d") -> Any:
    """Placement of the wire's error-feedback residual.

    ``layout="1d"`` (``collectives.ef_wire_init``): every leaf leads with
    its ``[n_data]`` shard axis, over the data axes; the rest replicates.
    ``layout="2d"`` (``collectives.ef_wire2d_init``): every leaf is the
    flat ``[n_data, n_model, C]`` slice stack, axis 0 over the data axes
    and axis 1 over ``model``, so rank ``(d, m)`` holds its own ``[C]``
    slice and nothing is replicated."""
    if layout not in ("1d", "2d"):
        raise ValueError(f"layout must be '1d' or '2d', got {layout!r}")
    daxes = _data_axes(mesh)
    entries = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    if layout == "2d":
        model = "model" if "model" in _axes_of(mesh)[0] else None
        return tree_map(
            lambda leaf: NamedSharding(mesh, P(entries, model, None)), tree)
    return tree_map(lambda leaf: NamedSharding(
        mesh, P(entries, *([None] * (leaf.ndim - 1)))), tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_tree(tree: Any, mesh, mode: str = "train") -> Any:
    """:func:`spec_for_param` over every leaf of a parameter tree (leaves
    need only a ``.shape``)."""
    pairs = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [
        NamedSharding(mesh, spec_for_param(path, leaf.shape, mesh, mode))
        for path, leaf in pairs])
