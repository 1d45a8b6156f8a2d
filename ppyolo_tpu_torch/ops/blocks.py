"""Pooling, upsample, CoordConv, SPP and DropBlock over NCHW tensors.

Counterparts of ``ppyolo_tpu/ops/blocks.py``.  Every op keeps its input's
memory format, so ``channels_last`` activations stay physically NHWC.
"""
from __future__ import annotations

from typing import Optional

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


def spp_parts(x: torch.Tensor) -> list:
    """The SPP pyramid [x, mp5, mp9, mp13] as a list (a virtual concat,
    ``ConvNormAct.forward_parts``)."""
    return [x, max_pool2d(x, 5, 1, 2), max_pool2d(x, 9, 1, 4), max_pool2d(x, 13, 1, 6)]


def spp(x: torch.Tensor) -> torch.Tensor:
    """Spatial pyramid pooling: concat [x, mp5, mp9, mp13] on channels."""
    return torch.cat(spp_parts(x), dim=1)


def drop_block(x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
               block_size: int = 3, keep_prob: float = 0.9) -> torch.Tensor:
    """Block-wise dropout (``ppyolo_tpu/ops/blocks.py:91-113``, reference
    custom_layers.py:293-342), training only: one fp32 uniform per element
    of x from ``generator`` (on x's device), then ``drop_block_uniform``."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return drop_block_uniform(x, u, block_size=block_size, keep_prob=keep_prob)


def drop_block_uniform(x: torch.Tensor, u: torch.Tensor, *, block_size: int = 3,
                       keep_prob: float = 0.9) -> torch.Tensor:
    """DropBlock from given uniforms u (x's shape): seeds where u < gamma,
    dilated by a block_size max-pool with padding 1 (the reference's, for
    any block size), survivors rescaled by numel / kept."""
    n, c, h, w = x.shape
    feat_area = float(h) ** 2
    useful = float(max(h - block_size + 1, 1)) ** 2  # guard tiny test grids
    gamma = feat_area * (1.0 - keep_prob) / (block_size * block_size * useful)
    seeds = (u < gamma).to(x.dtype)
    mask = 1.0 - max_pool2d(seeds, block_size, 1, 1)
    numel = float(n * h * w * c)
    return x * mask * numel / mask.sum()
