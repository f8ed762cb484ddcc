"""Learning-rate schedules (port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup + cosine decay; a multiplier in (0, 1], an f32 tensor
    on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
