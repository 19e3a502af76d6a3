"""Learning-rate schedules (port of ``repro.optim.schedule``): warmup +
cosine decay, and constant. Each returns ``lr(step)``, a 0-d float32
tensor on the step's device, computed in float32 as the reference's."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / float(max(1.0, warmup_steps))
        frac = torch.clamp((step - warmup_steps)
                           / float(max(1.0, total_steps - warmup_steps)),
                           0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr
