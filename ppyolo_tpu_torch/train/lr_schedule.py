"""Warmup + piecewise-decay LR as a function of the step.

Counterpart of ``ppyolo_tpu/train/lr_schedule.py`` (reference train.py:
172-188 ``calc_lr``), evaluated in fp32 as the JAX version is.
``make_lr_fn`` gives the host value of a step; ``DeviceLR`` gives the same
fp32 values from a step counter that lives on the device, so a CUDA graph
reads the LR of the step it replays.
"""
from __future__ import annotations

import numpy as np
import torch


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


class DeviceLR:
    """The LR of a device step counter, bitwise ``make_lr_fn``'s.

    The schedule is a warmup ramp, then one constant per number of
    milestones passed.  Both come from small fp32 tables made with
    ``make_lr_fn`` itself (the ramp for every warmup step, the constants
    for 0..len(milestones) passed); ``__call__`` counts the milestones
    passed and gathers from them on the device: no host read, no branch."""

    def __init__(self, learning_rate_cfg, device):
        lr_fn = make_lr_fn(learning_rate_cfg)
        pd = learning_rate_cfg["PiecewiseDecay"]
        milestones = list(pd["milestones"])
        self.warmup_steps = learning_rate_cfg["LinearWarmup"]["steps"]
        ramp_end = int(min([self.warmup_steps, *(m - 1 for m in milestones)]))
        ramp = [lr_fn(t) for t in range(max(ramp_end, 0) + 1)]
        base_lr, gamma = np.float32(learning_rate_cfg["base_lr"]), np.float32(pd["gamma"])
        decayed = [base_lr * gamma ** np.float32(n) for n in range(len(milestones) + 1)]
        self.ramp = torch.tensor(np.array(ramp, np.float32), device=device)
        self.decayed = torch.tensor(np.array(decayed, np.float32), device=device)
        # compared in fp32, as the host's np.float32 step is
        self.milestones = torch.tensor(np.array(milestones or [np.inf], np.float32),
                                       device=device)
        self.ramp_end = len(ramp) - 1

    def __call__(self, step_t: torch.Tensor) -> torch.Tensor:
        """step_t: int64 steps (any shape, 0-d in a train step) on the
        tables' device -> their fp32 LRs."""
        t = step_t.to(torch.float32)
        n_passed = (t.unsqueeze(-1) >= self.milestones).sum(-1)
        warm = torch.take(self.ramp, step_t.clamp(0, self.ramp_end))
        decayed = torch.take(self.decayed, n_passed)
        in_warm = (t <= float(self.warmup_steps)) & (n_passed == 0)
        return torch.where(in_warm, warm, decayed)
