"""Learning-rate schedules, step -> fp32 scalar tensor (port of
:mod:`repro.optim.schedules`; fp32 arithmetic as the reference's)."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32)
    return fn


def step_decay_schedule(lr: float, decay: float = 0.1, every: int = 100_000):
    """The paper's CaffeNet schedule: lr * decay^(floor(step/every))."""
    def fn(step):
        k = torch.floor(_step(step) / every)
        return lr * (decay ** k)
    return fn


def cosine_schedule(lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine decay
    to ``min_ratio * lr`` at ``total``."""
    def fn(step):
        s = _step(step)
        warm = lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return fn
