"""Momentum SGD with the reference's per-parameter group policy.

Counterpart of ``ppyolo_tpu/train/optimizer.py``: per trainable leaf,

    grad <- grad + wd_mult * l2_factor * param     (L2 regularizer)
    buf  <- momentum * buf + grad
    param <- param - lr_t * lr_mult * buf

which is ``torch.optim.SGD`` (dampening 0, no Nesterov; its first step sets
``buf = grad``, the JAX ``momentum * 0 + grad``) with one param group per
(lr_mult, wd_mult) and the group's lr set to ``lr_t * lr_mult`` before each
step.  Frozen leaves (``trainable=False``) stay out of the optimizer.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..ops.module import ParamPolicy


def make_sgd(params: Mapping[str, torch.nn.Parameter], flat_policy: Mapping[str, ParamPolicy],
             *, momentum: float = 0.9, l2_factor: float = 0.0005) -> torch.optim.SGD:
    """SGD over the trainable leaves of ``params`` ({path: parameter})."""
    groups: Dict[tuple, list] = {}
    for k, p in params.items():
        pol = flat_policy[k]
        if pol.trainable:
            groups.setdefault((pol.lr_mult, pol.wd_mult), []).append(p)
    return torch.optim.SGD(
        [{"params": ps, "lr_mult": lr_mult, "weight_decay": wd_mult * l2_factor}
         for (lr_mult, wd_mult), ps in groups.items()],
        lr=0.0, momentum=momentum)


def set_lr(optimizer: torch.optim.Optimizer, lr_t: float) -> None:
    for g in optimizer.param_groups:
        g["lr"] = lr_t * g["lr_mult"]
