"""LR schedules (port of ``repro.optim.schedules``): callables of the step,
a 0-dim integer tensor, that return a 0-dim fp32 tensor on its device."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup_cosine", "inverse_sqrt"]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, torch.as_tensor(step))


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine decay
    to ``floor`` at ``total_steps``."""

    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / _f32(max(warmup_steps, 1), s)
        t = torch.clamp((s - warmup_steps) / _f32(max(total_steps - warmup_steps, 1), s), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)

    return f


def inverse_sqrt(peak: float, warmup_steps: int):
    """Linear warm-up to ``peak``, then ``peak * sqrt(warmup_steps / step)``."""

    def f(step):
        s = torch.clamp_min(torch.as_tensor(step).to(torch.float32), 1.0)
        return peak * torch.minimum(s / _f32(max(warmup_steps, 1), s),
                                    torch.sqrt(_f32(warmup_steps, s) / s))

    return f
