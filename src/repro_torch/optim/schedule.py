"""Learning-rate schedules, as ``repro.optim.schedule``: a step (an int or
a 0-d tensor) in, an f32 0-d tensor out, on the step's device."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float):
    s = _step(step)
    return peak * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor: float = 0.0):
    s = _step(step)
    warm = linear_warmup(s, warmup_steps, peak)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, cos)
