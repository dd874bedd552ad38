"""Learning-rate schedules, in PyTorch.

Counterpart of ``dat_segmentation_tpu/train/schedules.py``: each is a
function of the 0-based step taken so far. Optax evaluates its schedule
at the update count *before* the update, so the first step uses
``base_lr * warmup_ratio``; the train step sets each group's lr to
``schedule(step)`` before ``optimizer.step()`` to the same effect.
"""

from __future__ import annotations

import math
from typing import Callable


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def warmup_poly_schedule(
    base_lr: float,
    max_iters: int,
    *,
    warmup_iters: int = 1500,
    warmup_ratio: float = 1e-6,
    power: float = 1.0,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """Linear warmup from ``base_lr * warmup_ratio``, then polynomial decay
    to ``min_lr`` at ``max_iters``."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            frac = _clip01(step / max(warmup_iters, 1))
            return base_lr * (warmup_ratio + (1.0 - warmup_ratio) * frac)
        frac = _clip01((step - warmup_iters) / max(max_iters - warmup_iters, 1))
        return (base_lr - min_lr) * (1.0 - frac) ** power + min_lr

    return schedule


def warmup_cosine_schedule(
    base_lr: float,
    max_iters: int,
    *,
    warmup_iters: int = 0,
    warmup_ratio: float = 1e-3,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """Linear warmup, then cosine from ``base_lr`` to ``min_lr``."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            frac = _clip01(step / max(warmup_iters, 1))
            return base_lr * (warmup_ratio + (1.0 - warmup_ratio) * frac)
        frac = _clip01((step - warmup_iters) / max(max_iters - warmup_iters, 1))
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * frac))

    return schedule


def build_schedule(cfg) -> Callable[[int], float]:
    """The schedule of a ``TrainConfig`` (``trainer_seg.build_schedule``)."""
    sch = cfg.schedule
    if sch.policy == "poly":
        return warmup_poly_schedule(
            cfg.optimizer.lr, sch.max_iters, warmup_iters=sch.warmup_iters,
            warmup_ratio=sch.warmup_ratio, power=sch.power, min_lr=sch.min_lr,
        )
    return warmup_cosine_schedule(
        cfg.optimizer.lr, sch.max_iters, warmup_iters=sch.warmup_iters,
        warmup_ratio=sch.warmup_ratio, min_lr=sch.min_lr,
    )
