"""Mesh builders (counterpart of ``repro/launch/mesh.py``): thin
wrappers over ``repro_torch.api``'s declarative :class:`MeshSpec`.

The port's meshes are ``None`` (one rank) or a ``dist.LocalMesh`` of
``data x model`` ranks as threads on one card; the reference's TPU pod
slices have no counterpart, and ``launch.dryrun --chips N`` is what
stands for them: the count of work of one cell, divided evenly over N
cards.
"""
from __future__ import annotations

from ..api.context import build_mesh
from ..api.spec import MeshSpec


def make_production_mesh(*, multi_pod: bool = False):
    """Raises, as ``build_mesh`` does for a production :class:`MeshSpec`
    (16x16 chips a pod in the reference)."""
    return build_mesh(MeshSpec.production(multi_pod=multi_pod))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """Host ``data x model`` mesh: ``None`` at 1x1, else a ``LocalMesh``
    on ``device`` (the card by default)."""
    return build_mesh(MeshSpec.host(data, model), device)


def data_axes(mesh) -> tuple:
    """All data-parallel axes of a mesh (``()`` for no mesh)."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
