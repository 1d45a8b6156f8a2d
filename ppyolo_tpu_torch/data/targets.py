"""Gt2YoloTarget on the device, in torch.

Counterpart of ``ppyolo_tpu/data/targets.py::gt2yolo_targets_device``
(same semantics, same ``[B, gh, gw, an, 6+C]`` layout per level): best
anchor per gt by wh-IoU against the anchors normalized by the image size
(``argmax`` takes the first of tied anchors, in both frameworks); a gt
writes into a level only where its best anchor belongs to the level's mask,
plus, with ``iou_thresh < 1``, every other anchor of the level above the
threshold.  On a (cell, slot) collision the later gt wins the fields
(tx, ty, tw, th, tscale, score), while class bits are multi-hot and never
clear.

The JAX builder finds each winner with bf16 priorities and gathers its row
with a one-hot matmul, because the TPU has no fast scatter or gather.  Here
the winner is a ``scatter_reduce`` max of integer priorities (1 + gt
index) and its row an index gather.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def gt2yolo_targets_device(gt_bbox: torch.Tensor, gt_class: torch.Tensor,
                           gt_score: torch.Tensor, im_hw: Tuple[int, int],
                           anchors: Sequence[Sequence[float]],
                           anchor_masks: Sequence[Sequence[int]],
                           downsample_ratios: Sequence[int], num_classes: int,
                           iou_thresh: float = 1.0) -> List[torch.Tensor]:
    """gt_bbox [B,M,4] normalized xywh, gt_class [B,M] int, gt_score [B,M]
    float, all on one device.  Returns per-level fp32 targets
    [B, gh, gw, an, 6+C] on that device."""
    h, w = im_hw
    dev = gt_bbox.device
    f32 = torch.float32
    anchors_t = torch.as_tensor(anchors, dtype=f32, device=dev).reshape(-1, 2)
    an_hw = anchors_t / torch.tensor([[w, h]], dtype=f32, device=dev)
    b, m = gt_class.shape
    gt_bbox = gt_bbox.to(f32)
    gt_score = gt_score.to(f32)
    gx, gy, gw_, gh_ = gt_bbox.unbind(-1)
    valid = (gw_ > 0) & (gh_ > 0) & (gt_score > 0)                    # [B,M]

    inter = (torch.minimum(gw_[..., None], an_hw[:, 0]) *
             torch.minimum(gh_[..., None], an_hw[:, 1]))
    union = (gw_ * gh_)[..., None] + (an_hw[:, 0] * an_hw[:, 1]) - inter
    ious = inter / torch.clamp_min(union, 1e-12)                       # [B,M,A]
    best_idx = torch.argmax(ious, dim=-1)                              # [B,M]
    vals = torch.stack([gx, gy, gw_, gh_, gt_score], dim=-1)           # [B,M,5]
    gt_index = torch.arange(m, device=dev)
    cls_index = gt_class.to(torch.int64)
    cls_ok = ((cls_index >= 0) & (cls_index < num_classes)).to(f32)
    cls_index = cls_index.clamp(0, num_classes - 1)

    out = []
    for mask, ds in zip(anchor_masks, downsample_ratios):
        grid_h, grid_w = int(h // ds), int(w // ds)
        an = len(mask)
        mask_t = torch.as_tensor(mask, device=dev)
        gi = torch.clamp((gx * grid_w).to(torch.int32), 0, grid_w - 1).to(torch.int64)
        gj = torch.clamp((gy * grid_h).to(torch.int32), 0, grid_h - 1).to(torch.int64)
        assigned = valid[..., None] & (best_idx[..., None] == mask_t)   # [B,M,an]
        if iou_thresh < 1.0:
            extra = (valid[..., None] & (best_idx[..., None] != mask_t)
                     & (ious[..., mask_t] > iou_thresh))
            assigned = assigned | extra
        # flat (cell, slot) of every (gt, slot); priority 1 + gt index wins
        slot = ((gj * grid_w + gi)[..., None] * an
                + torch.arange(an, device=dev)).reshape(b, m * an)     # [B,M*an]
        pri = torch.where(assigned, 1 + gt_index[:, None], 0).reshape(b, m * an)
        win = torch.zeros(b, grid_h * grid_w * an, dtype=torch.int64, device=dev)
        win.scatter_reduce_(1, slot, pri, reduce="amax")
        has = win > 0
        g = torch.gather(vals, 1, (win - 1).clamp_min(0)[..., None].expand(-1, -1, 5))
        g = g.reshape(b, grid_h, grid_w, an, 5)
        gx_s, gy_s, gw_s, gh_s, score_s = g.unbind(-1)
        aw = anchors_t[mask_t, 0]
        ah = anchors_t[mask_t, 1]
        tx = gx_s * grid_w - torch.arange(grid_w, device=dev)[None, None, :, None]
        ty = gy_s * grid_h - torch.arange(grid_h, device=dev)[None, :, None, None]
        tw = torch.log(torch.clamp_min(gw_s * w / aw, 1e-30))
        th = torch.log(torch.clamp_min(gh_s * h / ah, 1e-30))
        tscale = 2.0 - gw_s * gh_s
        hasf = has.reshape(b, grid_h, grid_w, an, 1).to(f32)
        fields = torch.stack([tx, ty, tw, th, tscale, score_s], dim=-1) * hasf
        # multi-hot classes: a bit for every assigned gt of the (cell, slot)
        cls_plane = torch.zeros(b, grid_h * grid_w * an * num_classes, device=dev)
        flat = slot * num_classes + cls_index.repeat_interleave(an, dim=1)
        bits = (assigned.to(f32) * cls_ok[..., None]).reshape(b, m * an)
        cls_plane.scatter_add_(1, flat, bits)
        cls_plane = cls_plane.clamp_max(1.0).reshape(b, grid_h, grid_w, an, num_classes)
        out.append(torch.cat([fields, cls_plane], dim=-1))
    return out
