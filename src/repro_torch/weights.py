"""Carry a JAX-package params / qstate tree into the port.

The caller hands the reference's trees over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, tree)``); the keys stay as they are,
so plan paths and the packing walker see the same tree.  Range-state
pairs (any named tuple with fields ``vmin``, ``vmax``) become the port's
``ActState``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .core.hgq import ActState
from .device import resolve_device


def _convert(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, dict):
        return {k: _convert(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and getattr(obj, "_fields", None) == \
            ("vmin", "vmax"):
        return ActState(*(_convert(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert(v, device) for v in obj)
    if obj is None:
        return None
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def from_jax(params: Any, qstate: Any, device=None) -> Tuple[Any, Any]:
    """(params, qstate) as nested numpy trees -> the port's trees on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    return _convert(params, dev), _convert(qstate, dev)
