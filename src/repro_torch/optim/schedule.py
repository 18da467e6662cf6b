"""LR schedules, the port of ``repro/optim/schedule.py``: pure functions of
the step, computed in f32 on the step's device as the reference computes
them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (so the LR at step 0 is 0), then a cosine decay
    to ``final_frac * peak_lr`` at ``total_steps``, flat beyond. ``step``
    is an int or a 0-d tensor; returns a 0-d f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    step = torch.as_tensor(step)
    return torch.tensor(peak_lr, dtype=torch.float32, device=step.device)
