"""Deterministic, resumable synthetic data (counterpart of
``repro/data/synthetic.py``; the paper's three kinds, jet, svhn and muon,
and the LM's token stream, lm).

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
import torch.nn.functional as F

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


def svhn_blob(y: torch.Tensor) -> torch.Tensor:
    """The class mark of an SVHN-shaped image: ``exp(-d^2 / 8)`` around
    (``4 + 3 (y % 5)``, ``8 + 12 (y // 5)``), [batch, 32, 32] float32."""
    cx = 4 + 3 * (y % 5)
    cy = 8 + 12 * (y // 5)
    ii = torch.arange(32, device=y.device)
    d2 = (ii[None, :, None] - cx[:, None, None]) ** 2 \
        + (ii[None, None, :] - cy[:, None, None]) ** 2
    return torch.exp(d2.to(torch.float32) / -8.0)


def svhn_batch(seed: int, step: int, batch: int = 256, device=None
               ) -> Dict[str, torch.Tensor]:
    """32x32x3 images whose class is a localized bright blob: x [batch, 32,
    32, 3] (NHWC) float32, uniform pixels plus ``2 * svhn_blob(y)`` on
    every channel; y [batch] int64, uniform over 10 classes."""
    dev = resolve_device(device)
    g = _gen(seed, step)
    y = torch.randint(0, 10, (batch,), generator=g)
    x = torch.rand((batch, 32, 32, 3), generator=g)
    x = x + 2.0 * svhn_blob(y)[..., None]
    return {"x": x.to(dev), "y": y.to(dev)}


# the muon stations' lever arms, and the strips a station layer holds
MUON_Z = (0.3, 0.5, 0.7)
MUON_STRIPS = 50


def muon_strips(angle: torch.Tensor) -> torch.Tensor:
    """The strip a straight track at ``angle`` fires in each station:
    ``round(25 + 80 * angle * z)`` (half to even) clipped to 0..49, [B, 3]
    int64."""
    z = torch.tensor(MUON_Z, device=angle.device)
    return torch.clamp(torch.round(25.0 + 80.0 * angle[:, None] * z[None, :]),
                       0, MUON_STRIPS - 1).to(torch.int64)


def muon_batch(seed: int, step: int, batch: int = 1024, device=None
               ) -> Dict[str, torch.Tensor]:
    """Three 3x50 binary hit maps of a straight track: the angle is
    U(-0.25, 0.25); each of a station's 3 layers fires ``muon_strips``
    moved cyclically by -1, 0 or 1 (uniform), plus noise hits
    Bernoulli(0.005).  stations [batch, 3, 150] float32 (0 or 1), target
    [batch] the angle in mrad."""
    dev = resolve_device(device)
    g = _gen(seed, step)
    angle = torch.rand((batch,), generator=g) * 0.5 - 0.25
    noise = torch.rand((batch, 3, 3, MUON_STRIPS), generator=g) < 0.005
    jitter = torch.randint(-1, 2, (batch, 3, 3), generator=g)
    fired = (muon_strips(angle)[:, :, None] + jitter) % MUON_STRIPS
    hits = F.one_hot(fired, MUON_STRIPS).to(torch.bool) | noise
    x = hits.to(torch.float32).reshape(batch, 3, 3 * MUON_STRIPS)
    return {"stations": x.to(dev), "target": (angle * 1000.0).to(dev)}


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None) -> Dict[str, torch.Tensor]:
    """Markov-ish token stream, so a model can bring the loss below
    log(vocab): uniform tokens, each replaced with probability 0.7 by
    ``31 * (the previous uniform token) % vocab`` (the first by the last
    one's, a cyclic roll).  tokens [batch, seq] int64."""
    dev = resolve_device(device)
    g = _gen(seed, step)
    base = torch.randint(0, vocab, (batch, seq), generator=g)
    shifted = torch.roll(base, 1, dims=1) * 31 % vocab
    use_rule = torch.rand((batch, seq), generator=g) < 0.7
    return {"tokens": torch.where(use_rule, shifted, base).to(dev)}


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
    kinds = {"jet": jet_batch, "svhn": svhn_batch, "muon": muon_batch}
    dev = resolve_device(device)
    if spec.kind == "lm":
        return lambda step: lm_batch(spec.seed, step, spec.batch, spec.seq,
                                     spec.vocab, device=dev)
    if spec.kind not in kinds:
        raise NotImplementedError(f"data kind {spec.kind!r} is not ported "
                                  f"yet (only {', '.join(kinds)}, lm)")
    batch_fn = kinds[spec.kind]
    return lambda step: batch_fn(spec.seed, step, spec.batch, device=dev)
