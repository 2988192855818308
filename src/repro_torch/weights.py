"""Carry JAX-package trees (params, qstate, optimizer state) into the port.

The caller hands the reference's trees over as nested containers of
numpy arrays (``jax.tree.map(np.asarray, tree)``); the keys stay as they
are, so plan paths, checkpoint keys and the packing walker see the same
tree.  Range-state pairs (any named tuple with fields ``vmin``, ``vmax``)
become the port's ``ActState``, AdamW states (fields ``step``, ``mu``,
``nu``) its ``AdamWState`` and error-feedback states (field
``residual``, the per-shard ``[n_data, ...]`` residual of the compressed
reduce or the post-reduce one) its ``EFState``, so a JAX run, its
gradient compression included, can resume in the port.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .core.hgq import ActState
from .device import resolve_device
from .dist import EFState
from .optim import AdamWState

_NAMED = {("vmin", "vmax"): ActState, ("step", "mu", "nu"): AdamWState,
          ("residual",): EFState}


def _convert(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, dict):
        return {k: _convert(v, device) for k, v in obj.items()}
    named = _NAMED.get(getattr(obj, "_fields", None)) \
        if isinstance(obj, tuple) else None
    if named is not None:
        return named(*(_convert(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert(v, device) for v in obj)
    if obj is None:
        return None
    return torch.from_numpy(np.array(obj, copy=True)).to(device)


def from_jax(*trees: Any, device=None) -> Tuple[Any, ...]:
    """Trees of numpy arrays (e.g. params, qstate, an ``AdamWState`` and
    an ``EFState``)
    -> the port's trees on ``device`` (the card by default), in order."""
    dev = resolve_device(device)
    return tuple(_convert(t, dev) for t in trees)
