"""Pairwise box IoU (reference model/matrix_nms.py:15-47), batched."""
from __future__ import annotations

import torch


def pairwise_iou(box_a: torch.Tensor, box_b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """IoU of [..., A, 4] x [..., B, 4] xyxy boxes -> [..., A, B].  ``eps``
    guards 0/0 for padded zero boxes (eps=0 reproduces the reference)."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / (union + eps)
