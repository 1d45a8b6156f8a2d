"""Warmup + piecewise-decay LR as a function of the step.

Counterpart of ``ppyolo_tpu/train/lr_schedule.py`` (reference train.py:
172-188 ``calc_lr``), evaluated in fp32 as the JAX version is.
"""
from __future__ import annotations

import numpy as np


def make_lr_fn(learning_rate_cfg):
    base_lr = np.float32(learning_rate_cfg["base_lr"])
    gamma = np.float32(learning_rate_cfg["PiecewiseDecay"]["gamma"])
    milestones = list(learning_rate_cfg["PiecewiseDecay"]["milestones"])
    sf = learning_rate_cfg["LinearWarmup"]["start_factor"]
    warmup_steps = learning_rate_cfg["LinearWarmup"]["steps"]
    start_factor = np.float32(sf)
    k = np.float32((1.0 - sf) / warmup_steps)   # a Python float in the JAX version

    def lr_fn(step: int) -> float:
        t = np.float32(step)
        n_passed = sum(1 for m in milestones if t >= m)
        if t <= warmup_steps and n_passed == 0:
            return float(base_lr * (start_factor + k * t))
        return float(base_lr * gamma ** np.float32(n_passed))

    return lr_fn
