"""Fault-tolerant checkpointing (counterpart of
``repro/train/checkpoint.py``), in the reference's layout so a checkpoint
written by either package loads into the other.

* Atomic: write ``<dir>/.tmp.<step>`` then ``os.replace`` to
  ``<dir>/step_XXXXXXXX``; a crash mid-write never corrupts the latest.
* Layout: one ``<tree>.npz`` per tree (``params``, ``qstate``, ``opt``),
  keyed by the flattened path (``d0/kernel/w``, ``inp/vmin``,
  ``mu/d0/kernel/f``), plus ``meta.json`` with the step.
* Resumable data: pipelines are (seed, step)-pure, so restoring ``step``
  alone replays the stream.
* Retention: the last N checkpoints plus every Pareto-pinned one.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten_with_path, tree_unflatten


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): leaf.detach().cpu().numpy()
            for path, leaf in tree_flatten_with_path(tree)}


def save(ckpt_dir: str, step: int, trees: Dict[str, Any],
         meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """trees: e.g. {'params': ..., 'qstate': ..., 'opt': ...}."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, tree in trees.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "trees": list(trees), **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        if not os.path.exists(os.path.join(ckpt_dir, d, "PARETO")):
            shutil.rmtree(os.path.join(ckpt_dir, d))


def mark_pareto(path: str) -> None:
    """Pin a checkpoint (Pareto-front member) against GC."""
    open(os.path.join(path, "PARETO"), "w").close()


def has_tree(ckpt_dir: str, step: int, name: str) -> bool:
    """Whether checkpoint ``step`` stored a tree under ``name``."""
    return os.path.exists(os.path.join(ckpt_dir, f"step_{step:08d}",
                                       f"{name}.npz"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, templates: Dict[str, Any]
            ) -> Tuple[int, Dict[str, Any]]:
    """Trees shaped like ``templates``, loaded by flattened key, each leaf
    in its template's dtype and on its template's device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = {}
    for name, template in templates.items():
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            leaves = []
            for kp, leaf in tree_flatten_with_path(template):
                key = "/".join(kp)
                arr = data[key]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(f"{name}/{key}: checkpoint {arr.shape} "
                                     f"vs template {tuple(leaf.shape)}")
                leaves.append(torch.from_numpy(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype))
        out[name] = tree_unflatten(template, leaves)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta["step"], out
