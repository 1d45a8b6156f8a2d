"""Gt2YoloTarget: on the host (numpy and the native scatter) and on the
device (torch).

``gt2yolo_targets`` is ``ppyolo_tpu/data/targets.py::gt2yolo_targets``,
the loader's builder when ``train_cfg['device_targets']`` is off: the same
numpy arithmetic, and the repository's native scatter when the host
library is built and ``iou_thresh == 1`` (bitwise the numpy path).
``gt2yolo_targets_device`` is the counterpart of ``gt2yolo_targets_device``
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

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import native


def _wh_iou(gw, gh, aw, ah):
    """IoU of corner-anchored boxes [0,0,w,h] (transform.py:1192-1208)."""
    inter = np.minimum(gw, aw) * np.minimum(gh, ah)
    union = gw * gh + aw * ah - inter
    return inter / np.maximum(union, 1e-12)


def _gt2yolo_native(gt_bbox, gt_class, gt_score, best_idx, valid, anchors,
                    anchor_masks, downsample_ratios, im_hw, num_classes):
    """C++ scatter path; returns None when the lib is unavailable."""
    _ptr = native._ptr
    lib = native.get_lib()
    if lib is None:
        return None
    h, w = im_hw
    b, m = gt_class.shape
    bbox = np.ascontiguousarray(gt_bbox, np.float32)
    cls = np.ascontiguousarray(gt_class, np.int32)
    score = np.ascontiguousarray(np.where(valid, gt_score, 0.0), np.float32)
    best = np.ascontiguousarray(best_idx, np.int32)
    anc = np.asarray(anchors, np.float32)
    # tw/th precomputed HERE with numpy's f32 log so the native path is
    # bitwise-identical to the numpy builder and the reference (the C++
    # libm logf rounds the last ulp differently); invalid rows are never
    # written by the scatter, so guard them out of the log
    bw = np.where(valid, gt_bbox[..., 2], 1.0).astype(np.float32)
    bh = np.where(valid, gt_bbox[..., 3], 1.0).astype(np.float32)
    aw = anc[best_idx, 0]
    ah = anc[best_idx, 1]
    tw = np.ascontiguousarray(np.log(bw * w / aw), np.float32)
    th = np.ascontiguousarray(np.log(bh * h / ah), np.float32)
    out = []
    for mask, ds in zip(anchor_masks, downsample_ratios):
        gh, gw = int(h // ds), int(w // ds)
        an = len(mask)
        target = np.zeros((b, gh, gw, an, 6 + num_classes), np.float32)
        mask_arr = np.ascontiguousarray(mask, np.int32)
        lib.gt2yolo_scatter(
            _ptr(bbox, ctypes.c_float), _ptr(cls, ctypes.c_int32),
            _ptr(score, ctypes.c_float), _ptr(best, ctypes.c_int32),
            b, m, _ptr(mask_arr, ctypes.c_int32), an,
            _ptr(tw, ctypes.c_float), _ptr(th, ctypes.c_float), gh, gw,
            6 + num_classes, _ptr(target, ctypes.c_float))
        out.append(target)
    return out


def gt2yolo_targets(
    gt_bbox: np.ndarray,      # [B, M, 4] normalized xywh (cx, cy, w, h)
    gt_class: np.ndarray,     # [B, M] int
    gt_score: np.ndarray,     # [B, M] float
    im_hw: Tuple[int, int],   # network input (h, w)
    anchors: Sequence[Sequence[float]],      # [[w, h], ...] pixel anchors
    anchor_masks: Sequence[Sequence[int]],
    downsample_ratios: Sequence[int],
    num_classes: int,
    iou_thresh: float = 1.0,
    use_native: bool = True,
) -> List[np.ndarray]:
    """Returns per-level float32 targets [B, gh, gw, an, 6+C].

    When the C++ host library is built and iou_thresh==1 (every PPYOLO
    recipe), the scatter runs natively (``native.py``); the numpy path is
    the always-available fallback and the parity oracle.
    """
    h, w = im_hw
    anchors = np.asarray(anchors, np.float32)                # [A, 2]
    an_hw = anchors / np.array([[w, h]], np.float32)         # normalized
    b, m = gt_class.shape

    gx, gy = gt_bbox[..., 0], gt_bbox[..., 1]
    gw, gh_ = gt_bbox[..., 2], gt_bbox[..., 3]
    valid = (gw > 0) & (gh_ > 0) & (gt_score > 0)            # [B, M]

    # best anchor per gt (strict > with init 0 => argmax over positive ious)
    ious = _wh_iou(gw[..., None], gh_[..., None],
                   an_hw[None, None, :, 0], an_hw[None, None, :, 1])  # [B,M,A]
    best_idx = np.argmax(ious, axis=-1)                      # [B, M]

    if use_native and iou_thresh >= 1.0:
        native_out = _gt2yolo_native(gt_bbox, gt_class, gt_score, best_idx,
                                     valid, anchors, anchor_masks,
                                     downsample_ratios, (h, w), num_classes)
        if native_out is not None:
            return native_out

    out = []
    bidx, midx = np.meshgrid(np.arange(b), np.arange(m), indexing="ij")
    for mask, ds in zip(anchor_masks, downsample_ratios):
        grid_h, grid_w = int(h // ds), int(w // ds)
        target = np.zeros((b, grid_h, grid_w, len(mask), 6 + num_classes),
                          np.float32)
        gi = np.clip((gx * grid_w).astype(np.int64), 0, grid_w - 1)
        gj = np.clip((gy * grid_h).astype(np.int64), 0, grid_h - 1)

        def write(sel, an_slot, aidx):
            if not np.any(sel):
                return
            bi, mi = bidx[sel], midx[sel]
            gii, gjj = gi[sel], gj[sel]
            sl = an_slot[sel] if isinstance(an_slot, np.ndarray) else np.full(
                len(bi), an_slot)
            ai = aidx[sel] if isinstance(aidx, np.ndarray) else np.full(
                len(bi), aidx)
            target[bi, gjj, gii, sl, 0] = (gx[sel] * grid_w) - gii
            target[bi, gjj, gii, sl, 1] = (gy[sel] * grid_h) - gjj
            target[bi, gjj, gii, sl, 2] = np.log(
                gw[sel] * w / anchors[ai, 0])
            target[bi, gjj, gii, sl, 3] = np.log(
                gh_[sel] * h / anchors[ai, 1])
            target[bi, gjj, gii, sl, 4] = 2.0 - gw[sel] * gh_[sel]
            target[bi, gjj, gii, sl, 5] = gt_score[sel]
            # NOTE: on a cell/slot collision the reference keeps the earlier
            # gt's class bit (it only ever sets 6+cls to 1, never clears —
            # transform.py:1395), so colliding gts leave a multi-hot class.
            target[bi, gjj, gii, sl, 6 + gt_class[sel].astype(np.int64)] = 1.0

        # The reference loop is purely CHRONOLOGICAL: gt b+1's write (best OR
        # extra) overwrites gt b's at a colliding (cell, slot) — a later gt's
        # multi-anchor extra beats an earlier gt's best-anchor write
        # (transform.py:1383-1419; proven by the directed collision case in
        # the JAX package's reference-parity tests).  One merged fancy write
        # per slot reproduces it: numpy fancy assignment is last-occurrence-
        # wins and sel flattens in ascending gt order.  Within one gt, best
        # and extra target different slots, so merging the two categories
        # cannot conflict.
        for slot, a in enumerate(mask):
            sel = valid & (best_idx == a)
            if iou_thresh < 1.0:
                iou_a = _wh_iou(gw, gh_, an_hw[a, 0], an_hw[a, 1])
                sel = sel | (valid & (best_idx != a) & (iou_a > iou_thresh))
            write(sel, slot, a)
        out.append(target)
    return out


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
