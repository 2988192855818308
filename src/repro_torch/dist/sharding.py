"""Placement rules that need no device mesh (the pure part of
``repro/dist/sharding.py``): which leaves carry a stacked-layer axis, and
which tensor axis a tensor-parallel ``model`` axis would shard.

The FSDP x TP placement of parameters, batches and caches over a mesh of
cards is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from ..tree import tree_flatten_with_path, tree_unflatten

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
    leaves always replicate."""
    shape = tuple(shape)
    if len(shape) < 2 or model_size <= 1:
        return None
    model_pos = len(shape) - 1 if shape[-1] >= shape[-2] else len(shape) - 2
    return model_pos if shape[model_pos] % model_size == 0 else None
