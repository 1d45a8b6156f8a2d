"""Momentum SGD with the reference's per-parameter group policy.

Counterpart of ``ppyolo_tpu/train/optimizer.py``: per trainable leaf,

    grad <- grad + wd_mult * l2_factor * param     (L2 regularizer)
    buf  <- momentum * buf + grad
    param <- param - lr_t * lr_mult * buf

as explicit ``torch._foreach`` ops over one group per (lr_mult, wd_mult),
so that a CUDA graph can capture the update: ``lr_t`` is a 0-d fp32 tensor
on the parameters' device (read by the kernels, never by the host), and the
momentum buffers exist from the start as zeros (the JAX ``init_momentum``),
so no first-step branch is baked into a graph.  The arithmetic is
``torch.optim.SGD``'s (dampening 0, no Nesterov): the decay and the update
are fused multiply-adds, and ``0 * m + g`` equals its first-step ``g``.
Frozen leaves (``trainable=False``) stay out of the optimizer.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from ..ops.module import ParamPolicy


class SGD:
    """Momentum SGD over ``params`` ({path: parameter}); ``bufs`` holds the
    momentum buffers by the same paths."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter],
                 flat_policy: Mapping[str, ParamPolicy], *, momentum: float = 0.9,
                 l2_factor: float = 0.0005):
        self.momentum = float(momentum)
        self.groups: Dict[Tuple[float, float], List[str]] = {}
        for k in params:
            pol = flat_policy[k]
            if pol.trainable:
                self.groups.setdefault((pol.lr_mult, pol.wd_mult * l2_factor), []).append(k)
        self.params = {k: params[k] for ks in self.groups.values() for k in ks}
        self.bufs = {k: torch.zeros_like(p, requires_grad=False) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor], lr_t: torch.Tensor) -> None:
        """One update from ``grads`` ({path: gradient}) at the 0-d ``lr_t``."""
        for (lr_mult, wd), keys in self.groups.items():
            ps = [self.params[k] for k in keys]
            bs = [self.bufs[k] for k in keys]
            gs = [grads[k] for k in keys]
            if wd != 0.0:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            torch._foreach_mul_(bs, self.momentum)
            torch._foreach_add_(bs, gs)
            neg_lr = lr_t * (-lr_mult)
            torch._foreach_addcmul_(ps, bs, [neg_lr.expand_as(p) for p in ps])
