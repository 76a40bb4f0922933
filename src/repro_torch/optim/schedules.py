"""LR schedules (paper setup: linear warmup, cosine decay to 10%)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """count (int tensor) -> lr at that count, an f32 tensor on count's device."""

    def schedule(count):
        count = count.float()
        warm = count / max(1.0, float(warmup_steps))
        progress = (count - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
        progress = torch.clamp(progress, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return lr * torch.where(count < warmup_steps, warm, cos)

    return schedule
