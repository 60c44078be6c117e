"""Learning-rate schedules, step → f32 scalar tensor (port of
``repro.optim.schedule``).  ``step`` is a number or a tensor; the result
lies on the step's device."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_linear(step, *, peak_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup, then linear decay to zero."""
    s = _steps(step)
    warm = s / max(1, warmup_steps)
    decay = (total_steps - s) / max(1, total_steps - warmup_steps)
    return peak_lr * torch.clamp(torch.minimum(warm, decay), 0.0, 1.0)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup, then cosine decay to ``floor * peak_lr``."""
    s = _steps(step)
    warm = torch.clamp(s / max(1, warmup_steps), 0.0, 1.0)
    frac = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
