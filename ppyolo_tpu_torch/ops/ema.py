"""Exponential moving average of the trainable parameters.

Counterpart of ``ppyolo_tpu/ops/ema.py``: the shadow is a flat
``{dotted_path: tensor}`` over the trainable leaves only, updated on the
device with ``decay_t = min(decay, (1+t)/(10+t))`` (reference EMA.py:37);
``ema_apply`` merges it over the live state (frozen leaves and BN running
stats at their current values, EMA.py:45-50).  The step may be a host int
or a 0-d device tensor (the train step's counter, so a CUDA graph reads the
decay of the step it replays); both give the same fp32 decay.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch


def ema_decay_at(step: int, decay: float) -> float:
    """``jnp.minimum(decay, (1 + step) / (10 + step))`` in fp32."""
    t = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1) + t) / (np.float32(10) + t)))


def ema_decay_device(step_t: torch.Tensor, decay: float) -> torch.Tensor:
    """``ema_decay_at`` of a 0-d integer step tensor, as a 0-d fp32 tensor
    on its device (the same fp32 operations: exact sums, one division)."""
    t = step_t.to(torch.float32)
    return torch.clamp((t + 1.0) / (t + 10.0), max=float(np.float32(decay)))


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               step: Union[int, torch.Tensor], decay: float) -> None:
    """In place: ``s = d * s + (1 - d) * p`` for every shadowed leaf."""
    keys = list(shadow)
    s = [shadow[k] for k in keys]
    d = (ema_decay_device(step, decay) if isinstance(step, torch.Tensor)
         else ema_decay_at(step, decay))
    torch._foreach_mul_(s, d)
    # 1 - d is exact in either form (d is an fp32 value)
    torch._foreach_add_(s, torch._foreach_mul([params[k] for k in keys], 1.0 - d))


def ema_apply(state_dict: Mapping[str, torch.Tensor],
              shadow: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state dict with the trainable leaves taken from the shadow."""
    out = dict(state_dict)
    out.update(shadow)
    return out
