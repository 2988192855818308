"""Logical-axis registry and pattern-string activation placement
(counterpart of ``repro/dist/axes.py``).

Layers name an activation's axes with one character each: ``'b'`` the
batch-like axis (over the data ranks), ``'m'`` a model-parallel axis
(heads, hidden features; over the ``model`` axis), ``'.'`` replicated.
The registry ``constrain`` reads is scoped, not global: a
``repro_torch.api.RunContext`` activates the :class:`AxisRegistry` of
its mesh around every call it owns (:func:`axis_scope`), and outside any
scope the single-device default applies.  Its readers: ``constrain``,
and the head-TP branch of ``nn.attention`` (``get_model_size``).

On the port's meshes (``dist.mesh``) each data shard's forward runs
whole on the card, so ``constrain`` checks the pattern, builds the spec
the reference would place the activation by (:func:`spec_for`) and
returns the tensor as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .scope import Scoped
from .sharding import P, PartitionSpec, _data_axes, _data_size, _mesh_sizes


@dataclasses.dataclass(frozen=True)
class AxisRegistry:
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    data_size: int = 1
    model_size: int = 1


_AXES: Scoped[AxisRegistry] = Scoped("repro_torch.dist.axes", AxisRegistry())


def axis_scope(registry: AxisRegistry):
    """Context manager: run the enclosed computation under ``registry``
    (re-entrant; restores the previous registry on exit)."""
    return _AXES.scope(registry)


def reset_axes() -> None:
    """Back to the single-device default (tests)."""
    _AXES.reset_default()


def get_axes() -> AxisRegistry:
    return _AXES.get()


def get_model_size() -> int:
    """Tensor-parallel degree currently in scope (1 = no TP)."""
    return _AXES.get().model_size


def get_data_size() -> int:
    return _AXES.get().data_size


def registry_for_mesh(mesh) -> AxisRegistry:
    """The :class:`AxisRegistry` of a mesh (``None`` is the 1 x 1 mesh;
    pod is outer data parallelism)."""
    if mesh is None:
        return AxisRegistry()
    return AxisRegistry(_data_axes(mesh) or ("data",), "model",
                        _data_size(mesh),
                        int(_mesh_sizes(mesh).get("model", 1)))


def spec_for(pattern: str, shape: Tuple[int, ...]) -> PartitionSpec:
    """The placement of a ``pattern`` tensor of ``shape`` under the registry
    in scope: ``'b'`` over the data axes and ``'m'`` over ``model`` where
    they divide the axis, else replicated."""
    reg = _AXES.get()
    entries = []
    for ch, dim in zip(pattern, shape):
        if ch == "b":
            ok = reg.data_size > 1 and dim % reg.data_size == 0
            entries.append(tuple(reg.data_axes) if ok else None)
        elif ch == "m":
            ok = reg.model_size > 1 and dim % reg.model_size == 0
            entries.append(reg.model_axis if ok else None)
        elif ch == ".":
            entries.append(None)
        else:
            raise ValueError(f"bad axis char {ch!r} in pattern {pattern!r}")
    return P(*entries)


def constrain(x: torch.Tensor, pattern: str) -> torch.Tensor:
    """Check a pattern string against ``x`` (one character an axis, see
    the module docstring), build its spec on a mesh of more than one rank,
    and return ``x``: each rank's activations lie whole on the card."""
    if len(pattern) != x.ndim:
        raise ValueError(f"pattern {pattern!r} has {len(pattern)} axes, "
                         f"array has {x.ndim} ({tuple(x.shape)})")
    bad = set(pattern) - set("bm.")
    if bad:
        raise ValueError(f"bad axis chars {sorted(bad)!r} in {pattern!r}")
    reg = _AXES.get()
    if reg.data_size * reg.model_size > 1:
        spec_for(pattern, tuple(x.shape))
    return x
