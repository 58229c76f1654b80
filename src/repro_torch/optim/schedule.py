"""Learning-rate schedules — the port of ``repro/optim/schedule.py``: pure
functions of the integer step, in float32 on the step's device (a step
held in a tensor is read on its device, never on the host)."""
from __future__ import annotations

import math

import torch


def _step(step):
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def warmup_linear(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        lin = peak + (floor - peak) * prog
        return torch.where(step < warmup, warm, lin)
    return f
