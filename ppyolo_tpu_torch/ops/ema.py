"""Exponential moving average of the trainable parameters.

Counterpart of ``ppyolo_tpu/ops/ema.py``: the shadow is a flat
``{dotted_path: tensor}`` over the trainable leaves only, updated on the
device with ``decay_t = min(decay, (1+t)/(10+t))`` (reference EMA.py:37);
``ema_apply`` merges it over the live state (frozen leaves and BN running
stats at their current values, EMA.py:45-50).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def ema_decay_at(step: int, decay: float) -> float:
    """``jnp.minimum(decay, (1 + step) / (10 + step))`` in fp32."""
    t = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1) + t) / (np.float32(10) + t)))


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               step: int, decay: float) -> None:
    """In place: ``s = d * s + (1 - d) * p`` for every shadowed leaf."""
    d = ema_decay_at(step, decay)
    keys = list(shadow)
    s = [shadow[k] for k in keys]
    torch._foreach_mul_(s, d)
    torch._foreach_add_(s, [params[k] for k in keys], alpha=float(np.float32(1) - np.float32(d)))


def ema_apply(state_dict: Mapping[str, torch.Tensor],
              shadow: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state dict with the trainable leaves taken from the shadow."""
    out = dict(state_dict)
    out.update(shadow)
    return out
