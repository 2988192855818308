"""Deterministic, resumable synthetic data (counterpart of
``repro/data/synthetic.py``; the jet kind so far).

Every batch is a pure function of (seed, step), drawn on the CPU from a
``torch.Generator`` seeded from both and then moved to the device, so a
restart at step k replays the same data with no iterator state, and the
card and the CPU see the same numbers.  The distributions match the JAX
package's; the numbers do not (another generator).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..device import resolve_device


def _gen(seed: int, step: int) -> torch.Generator:
    if not (0 <= seed < 2 ** 31 and 0 <= step < 2 ** 32):
        raise ValueError(f"seed {seed} / step {step} out of range")
    return torch.Generator().manual_seed((int(seed) << 32) | int(step))


def _jet_centers(n_classes: int, d: int) -> torch.Tensor:
    """Fixed class centres, N(0, 1.5^2) per coordinate."""
    return torch.randn((n_classes, d),
                       generator=torch.Generator().manual_seed(7)) * 1.5


def jet_batch(seed: int, step: int, batch: int = 1024, d: int = 16,
              n_classes: int = 5, device=None) -> Dict[str, torch.Tensor]:
    """5 Gaussian class clusters in 16-d (jet-tagging shaped): x [batch, d]
    float32, y [batch] int64."""
    dev = resolve_device(device)
    g = _gen(seed, step)
    y = torch.randint(0, n_classes, (batch,), generator=g)
    x = _jet_centers(n_classes, d)[y] + torch.randn((batch, d), generator=g)
    return {"x": x.to(dev), "y": y.to(dev)}


@dataclasses.dataclass(frozen=True)
class DataSpec:
    kind: str           # jet | svhn | muon | lm | asr
    batch: int
    seq: int = 0
    vocab: int = 0
    seed: int = 0


def make_pipeline(spec: DataSpec, device=None
                  ) -> Callable[[int], Dict[str, torch.Tensor]]:
    """step -> batch dict on ``device`` (the card by default)."""
    if spec.kind != "jet":
        raise NotImplementedError(f"data kind {spec.kind!r} is not ported "
                                  f"yet (only 'jet')")
    dev = resolve_device(device)
    return lambda step: jet_batch(spec.seed, step, spec.batch, device=dev)
