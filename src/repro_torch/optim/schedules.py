"""Learning-rate schedules (warmup + cosine/linear decay, constant).

The port of ``repro/optim/schedules.py``: each schedule maps an int step
tensor to an f32 learning-rate tensor on the step's device, in the
reference's order of f32 operations, so ``AdamW(learning_rate=schedule)``
reads it at each update without a host round trip.
"""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32, device=step.device)


def _warm(peak: float, warmup_steps: int, total_steps: int, step: torch.Tensor):
    """(the step as f32, the warmup ramp, the decay's progress in [0, 1])."""
    step = step.to(torch.float32)
    warm = peak * step / max(1.0, warmup_steps)
    t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    return step, warm, torch.clamp(t, 0.0, 1.0)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warmup to ``peak``, then cosine decay to ``floor``."""

    def sched(step):
        step, warm, t = _warm(peak, warmup_steps, total_steps, step)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def warmup_linear(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warmup to ``peak``, then linear decay to ``floor``."""

    def sched(step):
        step, warm, t = _warm(peak, warmup_steps, total_steps, step)
        lin = peak + (floor - peak) * t
        return torch.where(step < warmup_steps, warm, lin)

    return sched
