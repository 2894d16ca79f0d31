"""LR schedules (pure functions of the step counter; port of
``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
):
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``min_ratio * peak_lr``.  A float32 0-d tensor, computed in float32 in
    the reference's op order, on ``step``'s device (the CPU for a Python
    number).  Step 0 gives exactly 0.0."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
