"""LR schedules as callables of the (1-based) step count, a number or a
tensor; the warm-up schedules return a f32 tensor."""
from __future__ import annotations

import math

import torch


def _as_f32(count) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count.to(torch.float32)
    return torch.tensor(float(count), dtype=torch.float32)


def constant(lr: float):
    return lambda count: lr


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(count):
        c = _as_f32(count)
        warm = peak * c / max(warmup_steps, 1)
        t = torch.clamp((c - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(c < warmup_steps, warm, cos)
    return f


def inverse_sqrt(peak: float, warmup_steps: int):
    def f(count):
        c = _as_f32(count)
        warm = peak * c / max(warmup_steps, 1)
        decay = peak * (warmup_steps / torch.clamp_min(c, warmup_steps)) ** 0.5
        return torch.where(c < warmup_steps, warm, decay)
    return f
