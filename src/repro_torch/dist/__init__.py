"""Distribution utilities (counterpart of ``repro/dist``).

* :mod:`.scope` -- per-call dynamic scope;
* :mod:`.axes` -- the logical-axis registry of a mesh;
* :mod:`.sharding` -- the placement rules (FSDP x TP) as the port's spec
  trees, the stacked-layer rule and the ``model`` axis rule;
* :mod:`.mesh` -- ``data x model`` meshes: ``LocalMesh`` (ranks as
  threads on one card) and ``ProcessGroupMesh`` (``torch.distributed``);
* :mod:`.collectives` -- the compressed mean all-reduce (two-phase
  exchange, error feedback on both phases), 1D over the data axis and 2D
  sliced over ``data x model``;
* :mod:`.perf` -- the compute-dtype and packed-routing scopes and
  serving-weight packing;
* this module -- post-reduce error-feedback gradient compression.

Error feedback: each step compresses ``grad + residual`` and carries the
quantization error forward, so the time-averaged delivered gradient is
unbiased and the residual stays within one quantization step.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..kernels.wire_pack.ref import true_div
from ..tree import tree_map
from .collectives import (WIRE_KINDS, ef_wire2d_init, ef_wire_init,
                          ef_wire_pmean, ef_wire_pmean_2d, record_wire_bytes,
                          simulate_wire_pmean, simulate_wire_pmean_2d,
                          wire_bytes_model)
from .mesh import LocalMesh, ProcessGroupMesh
from .perf import (is_packed, pack_params_for_serving, packed_mantissas,
                   packed_storage, unpack_weight)
from .sharding import is_stacked_path, stacked_tree

EF_KINDS = ("none", "bf16", "int8")

__all__ = ["EFState", "EF_KINDS", "LocalMesh", "ProcessGroupMesh",
           "WIRE_KINDS", "ef_compress", "ef_init", "ef_wire2d_init",
           "ef_wire_init", "ef_wire_pmean", "ef_wire_pmean_2d", "is_packed",
           "is_stacked_path", "pack_params_for_serving", "packed_mantissas",
           "packed_storage", "record_wire_bytes", "simulate_wire_pmean",
           "simulate_wire_pmean_2d", "stacked_tree", "unpack_weight",
           "wire_bytes_model"]


class EFState(NamedTuple):
    """Per-leaf quantization residual carried across steps."""
    residual: Any


def ef_init(grads: Any) -> EFState:
    return EFState(residual=tree_map(torch.zeros_like, grads))


def _compress_leaf(e: torch.Tensor, kind: str, stacked: bool = False
                   ) -> torch.Tensor:
    if kind == "bf16":
        return e.to(torch.bfloat16).to(e.dtype)
    # int8: symmetric grid, max|e| -> 127; a stacked [L, ...] leaf (marked
    # by its tree path) gets one grid per layer, so an outlier layer does
    # not crush the others' resolution
    if stacked and e.ndim >= 3:
        amax = torch.amax(torch.abs(e), dim=tuple(range(1, e.ndim)),
                          keepdim=True)
    else:
        amax = torch.amax(torch.abs(e))
    scale = true_div(torch.clamp(amax, min=1e-30), 127.0)
    return torch.round(e / scale) * scale


def ef_compress(grads: Any, state: EFState, *, kind: str = "int8",
                stacked: Any = None) -> Tuple[Any, EFState]:
    """Compress ``grads`` with error feedback: ``(sent, new_state)``,
    ``sent`` what goes over the wire (apply it to the optimizer) and
    ``new_state`` carrying ``(grad + residual) - sent``.  ``stacked``
    optionally marks stacked-layer leaves (default: the tree paths)."""
    if kind not in EF_KINDS:
        raise ValueError(
            f"unsupported gradient compression kind {kind!r}; "
            f"supported: {EF_KINDS}")
    if kind == "none":
        return grads, state
    if stacked is None:
        stacked = stacked_tree(grads)
    err = tree_map(torch.add, grads, state.residual)
    sent = tree_map(lambda e, s: _compress_leaf(e, kind, s), err, stacked)
    residual = tree_map(torch.sub, err, sent)
    return sent, EFState(residual=residual)
