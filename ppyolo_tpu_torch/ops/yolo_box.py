"""Grid-sensitive YOLO box decode with the IoU-aware score fuse.

Counterpart of ``ppyolo_tpu/ops/yolo_box.py`` (``de_sigmoid``,
``_rescale_clip``, ``yolo_box_serving``).  Box math and the IoU-aware fuse
run in fp32; the fused objectness is rounded to the map's dtype before its
sigmoid, and the class scores stay in the map's dtype (bf16 in serving).
Anchors flatten in (S, S, an) order, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch


def de_sigmoid(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Inverse sigmoid with the reference's double clamp (head.py:97-109)."""
    x = x.clamp(eps, 1.0 / eps)
    x = 1.0 / x - 1.0
    x = x.clamp(eps, 1.0 / eps)
    return -torch.log(x)


def _rescale_clip(boxes: torch.Tensor, im_size: torch.Tensor, net: float,
                  clip_bbox: bool) -> torch.Tensor:
    """Rescale [N,A,4] boxes from network-input to original-image pixels."""
    imh = im_size[:, 0:1].float()
    imw = im_size[:, 1:2].float()
    sx = (imw / net)[:, :, None]
    sy = (imh / net)[:, :, None]
    x0 = boxes[:, :, 0:1] * sx
    y0 = boxes[:, :, 1:2] * sy
    x1 = boxes[:, :, 2:3] * sx
    y1 = boxes[:, :, 3:4] * sy
    if clip_bbox:
        x0 = x0.clamp_min(0.0)
        y0 = y0.clamp_min(0.0)
        x1 = torch.minimum(x1, imw[:, :, None])
        y1 = torch.minimum(y1, imh[:, :, None])
    return torch.cat([x0, y0, x1, y1], dim=-1)


def yolo_box_serving(output: torch.Tensor, anchors: torch.Tensor, stride: int,
                     num_classes: int, scale_x_y: float, im_size: torch.Tensor,
                     clip_bbox: bool, *, iou_aware_factor: Optional[float] = None):
    """Decode one level.  output [N, an*(6+C) or an*(5+C), S, S] raw head map
    (NCHW); anchors [an, 2] (w, h), any dtype, on the map's device (cast to
    fp32 there).  Returns (boxes [N, S*S*an, 4] fp32 xyxy
    in original-image pixels, scores [N, S*S*an, C] in the map's dtype)."""
    out = output.permute(0, 2, 3, 1)                    # NHWC view
    n, s, s2, _ = out.shape
    if s != s2:
        raise ValueError("decode assumes a square grid (reference head.py:24-27)")
    an = anchors.shape[0]
    c5 = 5 + num_classes
    base = an if iou_aware_factor is not None else 0
    f32 = torch.float32
    grid = torch.arange(s, dtype=f32, device=out.device)
    gx = grid[None, None, :]                            # varies along W
    gy = grid[None, :, None]                            # varies along H
    anchors = anchors.to(device=out.device, dtype=f32)
    boxes_a, scores_a = [], []
    for a in range(an):
        blk = out[..., base + a * c5: base + (a + 1) * c5]
        box_raw = blk[..., 0:4].to(f32)
        sig_xy = torch.sigmoid(box_raw[..., 0:2])
        px = (scale_x_y * sig_xy[..., 0] + gx - (scale_x_y - 1.0) * 0.5) * stride
        py = (scale_x_y * sig_xy[..., 1] + gy - (scale_x_y - 1.0) * 0.5) * stride
        pwh = torch.exp(box_raw[..., 2:4]) * anchors[a]
        pxy = torch.stack([px, py], dim=-1)
        boxes_a.append(torch.cat([pxy - pwh * 0.5, pxy + pwh * 0.5], dim=-1))
        if iou_aware_factor is not None:
            f = float(iou_aware_factor)
            ioup = torch.sigmoid(out[..., a].to(f32))
            obj = torch.sigmoid(blk[..., 4].to(f32))
            fused = de_sigmoid(torch.pow(obj, 1.0 - f) * torch.pow(ioup, f))
            conf = torch.sigmoid(fused.to(out.dtype))[..., None]
        else:
            conf = torch.sigmoid(blk[..., 4:5])
        scores_a.append(conf * torch.sigmoid(blk[..., 5:]))
    boxes = torch.stack(boxes_a, dim=3).reshape(n, s * s * an, 4)
    scores = torch.stack(scores_a, dim=3).reshape(n, s * s * an, num_classes)
    return _rescale_clip(boxes, im_size, float(s * stride), clip_bbox), scores
