"""Logical-axis registry and pattern-string activation placement
(counterpart of ``repro/dist/axes.py``).

Layers name an activation's axes with one character each: ``'b'`` the
batch-like axis (over the data ranks), ``'m'`` a model-parallel axis
(heads, hidden features; over the ``model`` axis), ``'.'`` replicated.
The registry ``constrain`` reads is scoped, not global: a
``repro_torch.api.RunContext`` activates the :class:`AxisRegistry` of
its mesh around every call it owns (:func:`axis_scope`), and outside any
scope the single-device default applies.

The port's meshes are data meshes (``dist.mesh``), whose ranks each hold
whole activations: on a model axis of 1 ``constrain`` is the identity.
A model axis above 1 (tensor parallelism, DTensor placement) is not
ported yet (ROADMAP Queue 1 item 10), and ``constrain`` raises there.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .scope import Scoped

_MODEL_AXIS = ("a model axis above 1 (tensor parallelism, DTensor "
               "placement) is not ported yet: ROADMAP Queue 1 item 10")


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
    """The :class:`AxisRegistry` of a mesh: ``None`` is the 1x1 mesh; a
    ``dist.LocalMesh`` or ``dist.ProcessGroupMesh`` is a data mesh of its
    ``size`` ranks and no model axis."""
    if mesh is None:
        return AxisRegistry()
    return AxisRegistry(("data",), "model", int(mesh.size), 1)


def constrain(x: torch.Tensor, pattern: str) -> torch.Tensor:
    """Check a pattern string against ``x`` (one character an axis, see
    the module docstring) and return ``x``: on the port's data meshes an
    activation needs no placement.  Raises on a model axis above 1."""
    if len(pattern) != x.ndim:
        raise ValueError(f"pattern {pattern!r} has {len(pattern)} axes, "
                         f"array has {x.ndim} ({tuple(x.shape)})")
    bad = set(pattern) - set("bm.")
    if bad:
        raise ValueError(f"bad axis chars {sorted(bad)!r} in {pattern!r}")
    if _AXES.get().model_size > 1:
        raise NotImplementedError(_MODEL_AXIS)
    return x
