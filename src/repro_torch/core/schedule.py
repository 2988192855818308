"""beta / learning-rate schedules (counterpart of ``repro/core/schedule.py``).

A schedule maps a step (an int or an integer tensor) to a float32
scalar tensor on the CPU, which broadcasts into arithmetic on any device.
The paper sweeps the resource strength beta along a log ramp within one
run (e.g. 1e-6 -> 1e-4 for jet tagging); gamma stays fixed (2e-6).
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=torch.float32)


def constant(v: float) -> Schedule:
    def fn(step):
        return torch.tensor(v, dtype=torch.float32)
    return fn


def log_ramp(v0: float, v1: float, total_steps: int) -> Schedule:
    """beta(t) = v0 * (v1/v0)^(t / T), clamped at v1 (paper SSec. V.B-D)."""
    lv0 = torch.tensor(math.log(v0), dtype=torch.float32)
    dlv = torch.tensor(math.log(v1) - math.log(v0), dtype=torch.float32)

    def fn(step):
        t = torch.clamp(_f32(step) / float(max(total_steps, 1)), 0.0, 1.0)
        return torch.exp(lv0 + t * dlv)
    return fn


def linear_warmup_cosine(peak: float, warmup: int, total: int,
                         floor: float = 0.0) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos).to(torch.float32)
    return fn
