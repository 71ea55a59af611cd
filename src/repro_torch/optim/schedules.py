"""Learning-rate schedules (pure functions of step) — the port of
``repro/optim/schedules.py``: f32 arithmetic on the step, returned as a
0-d f32 tensor on the step's device (the CPU for a Python int)."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_warmup(step, *, peak_lr: float, warmup_steps: int):
    s = _step_f32(step)
    return peak_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    s = _step_f32(step)
    warm = (s + 1) / max(warmup_steps, 1)
    progress = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
