"""Learning-rate schedules as plain functions of the step count
(counterpart of serenade_tpu/schedulers.py, without optax).

``SCHEDULERS[name](lr, **params)`` returns ``schedule(count) -> lr``,
where count is the number of updates made so far (0 for the first).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float = 0.5,
                 **_unused) -> Callable[[int], float]:
    """lr * gamma^(number of milestones <= count), as optax's
    ``piecewise_constant_schedule`` applies each boundary."""
    bounds = sorted(int(m) for m in milestones)
    return lambda count: lr * gamma ** sum(count >= m for m in bounds)


def warmup_lr(lr: float, warmup_steps: int = 25000,
              **_unused) -> Callable[[int], float]:
    """lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5), s = count + 1."""

    def schedule(count):
        s = count + 1.0
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)

    return schedule


def noam_lr(lr: float, model_size: int = 320, warmup_steps: int = 25000,
            **_unused) -> Callable[[int], float]:
    """lr * model_size^-0.5 * min(s^-0.5, s * warmup^-1.5), s = count + 1."""

    def schedule(count):
        s = count + 1.0
        return lr * model_size ** -0.5 * min(s ** -0.5,
                                             s * warmup_steps ** -1.5)

    return schedule


def constant_lr(lr: float, **_unused) -> Callable[[int], float]:
    return lambda count: lr


SCHEDULERS: Dict[str, Callable[..., Callable[[int], float]]] = {
    "MultiStepLR": multistep_lr,
    "WarmupLR": warmup_lr,
    "NoamLR": noam_lr,
    "ConstantLR": constant_lr,
}
