"""LR schedules with a warmup ramp (port of
``nova_pointcloud_tpu/engine/lr_schedules.py``): constant, cosine decay to
``lr_min`` and multi-step (gamma at each milestone), each with a linear
warmup from ``warmup_factor * lr`` to ``lr`` over ``warmup_steps``. Each
returns ``schedule(step) -> lr`` (a Python float)."""

import math
from typing import Sequence


def _warmup(step, base_lr: float, warmup_steps: int, warmup_factor: float) -> float:
    if warmup_steps <= 0:
        return base_lr
    alpha = min(step / warmup_steps, 1.0)
    return base_lr * (warmup_factor * (1 - alpha) + alpha)


def constant_lr(lr: float, warmup_steps: int = 0, warmup_factor: float = 0.001):
    def schedule(step):
        return _warmup(int(step), lr, warmup_steps, warmup_factor)

    return schedule


def cosine_lr(lr: float, max_steps: int, lr_min: float = 0.0, warmup_steps: int = 0,
              warmup_factor: float = 0.001):
    def schedule(step):
        step = int(step)
        if step < warmup_steps:
            return _warmup(step, lr, warmup_steps, warmup_factor)
        t = min(max((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(math.pi * t))

    return schedule


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float = 0.1,
                 warmup_steps: int = 0, warmup_factor: float = 0.001):
    ms = list(milestones)

    def schedule(step):
        step = int(step)
        if step < warmup_steps:
            return _warmup(step, lr, warmup_steps, warmup_factor)
        return lr * gamma ** sum(step >= m for m in ms)

    return schedule
