"""Pooling, upsample, CoordConv and SPP over NCHW tensors.

Counterparts of ``ppyolo_tpu/ops/blocks.py``.  Every op keeps its input's
memory format, so ``channels_last`` activations stay physically NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, ksize: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool with implicit -inf padding (torch semantics)."""
    return F.max_pool2d(x, ksize, stride, padding)


def avg_pool2d(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """Average pool without padding (torch ``AvgPool2d(k, s, 0)``)."""
    return F.avg_pool2d(x, ksize, stride)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def coord_planes(h: int, w: int, dtype, device) -> torch.Tensor:
    """The CoordConv planes as one batch-1 [1,2,h,w] tensor: channel 0 is x
    (varies along W), channel 1 is y (varies along H), both in [-1, 1]."""
    gx = torch.arange(w, dtype=dtype, device=device) / (w - 1) * 2.0 - 1.0
    gy = torch.arange(h, dtype=dtype, device=device) / (h - 1) * 2.0 - 1.0
    return torch.stack([gx.view(1, w).expand(h, w),
                        gy.view(h, 1).expand(h, w)])[None]


def coord_conv(x: torch.Tensor) -> torch.Tensor:
    """Append the x/y coordinate channels (reference custom_layers.py:256-272)."""
    n, _, h, w = x.shape
    g = coord_planes(h, w, x.dtype, x.device).expand(n, 2, h, w)
    return torch.cat([x, g], dim=1)


def spp(x: torch.Tensor) -> torch.Tensor:
    """Spatial pyramid pooling: concat [x, mp5, mp9, mp13] on channels."""
    return torch.cat([x, max_pool2d(x, 5, 1, 2), max_pool2d(x, 9, 1, 4),
                      max_pool2d(x, 13, 1, 6)], dim=1)
