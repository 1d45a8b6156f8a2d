"""Pieces of the plain reference that belong to no one architecture: fp32
without TF32, box IoU, the serving resize and the He init's std."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_exact():
    """fp32 matrix products and convolutions without TF32 on a card."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def pairwise_iou(a, b):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-9)


def resize_bicubic(img_bgr_u8: torch.Tensor, size: int) -> torch.Tensor:
    """[H,W,3] BGR uint8 -> [size,size,3] RGB uint8: bicubic (a = -0.75,
    half-pixel centres, no antialias), rounded and clamped to uint8."""
    x = img_bgr_u8.flip(-1).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


def kaiming_std(shape) -> float:
    return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
