"""PP-YOLO fine-grained YOLOv3 loss stack.

Counterpart of ``ppyolo_tpu/train/losses.py`` (reference model/losses.py:
85-356 and model/iou_losses.py:15-246), term for term: Grid-Sensitive L1
xy loss (BCE when ``scale_x_y == 1``), L1 wh loss, IoU loss, IoU-aware
loss, objectness with the IoU-ignore mask, per-class BCE.  Gradients stop
where the JAX package has ``stop_gradient``: the decoded gt boxes, the
IoU-aware target, the CIoU alpha and the ignore mask.

Every BCE is computed from logits with the eps-free capped softplus
(``_bce_logits``; ``ROADMAP.md`` §3 "Loss numerics"): the reference's
``log(s + 1e-9)`` form turns into ``log(0)`` once a compiler folds the
eps, and a logit of 30 then gives NaN.

The head's maps arrive NCHW ``[N, an*(6+C), S, S]`` and are cast to fp32,
then permuted to the JAX layout ``[N, S, S, an*(6+C)]``: the ``an``
IoU-aware channels first, then per anchor x, y, w, h, obj and the classes.
Targets are ``[N, S, S, an, 6+C]`` (``data/targets.py``), gt boxes
``[N, 50, 4]`` normalized xywh.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.iou import pairwise_iou

_EPS_CAP = 20.72326583694641  # -log(1e-9)


def _bce_logits(logit, target, cap: float = _EPS_CAP):
    """BCE from logits, ``t*(-log s) + (1-t)*(-log(1-s))`` with s =
    sigmoid(logit), each term capped at -log(1e-9) (the reference's eps as
    a loss cap)."""
    pos = torch.clamp_max(F.softplus(-logit), cap)   # -log(sigmoid(x))
    neg = torch.clamp_max(F.softplus(logit), cap)    # -log(1-sigmoid(x))
    return target * pos + (1.0 - target) * neg


def _grids(s: int, ref: torch.Tensor):
    gx = torch.arange(s, dtype=ref.dtype, device=ref.device)[None, None, :, None]
    gy = torch.arange(s, dtype=ref.dtype, device=ref.device)[None, :, None, None]
    return gx, gy


def _bbox_transform(dx, dy, dw, dh, anchors_wh, downsample, scale_x_y, *,
                    is_gt: bool, eps: float = 1e-10):
    """Encoded xywh [N,S,S,an] -> normalized corner boxes (iou_losses.py:135-191)."""
    s = dx.shape[1]
    gx, gy = _grids(s, dx)
    if is_gt:
        cx = (dx + gx) / s
        cy = (dy + gy) / s
    else:
        sx = torch.sigmoid(dx)
        sy = torch.sigmoid(dy)
        if abs(scale_x_y - 1.0) > eps:
            sx = scale_x_y * sx - 0.5 * (scale_x_y - 1.0)
            sy = scale_x_y * sy - 0.5 * (scale_x_y - 1.0)
        cx = (sx + gx) / s
        cy = (sy + gy) / s
    aw = anchors_wh[:, 0][None, None, None, :]
    ah = anchors_wh[:, 1][None, None, None, :]
    pw = torch.exp(dw) * aw / (s * downsample)
    ph = torch.exp(dh) * ah / (s * downsample)
    out = (cx - 0.5 * pw, cy - 0.5 * ph, cx + 0.5 * pw, cy + 0.5 * ph)
    if is_gt:
        out = tuple(v.detach() for v in out)
    return out


def _elementwise_iou(pred, gt, eps: float = 1e-10):
    """Same-position IoU of decoded boxes (iou_losses.py:76-98)."""
    x1, y1, x2, y2 = pred
    x1g, y1g, x2g, y2g = gt
    x2 = torch.maximum(x1, x2)
    y2 = torch.maximum(y1, y2)
    xi1 = torch.maximum(x1, x1g)
    yi1 = torch.maximum(y1, y1g)
    xi2 = torch.minimum(x2, x2g)
    yi2 = torch.minimum(y2, y2g)
    inter = torch.clamp_min(xi2 - xi1, 0.0) * torch.clamp_min(yi2 - yi1, 0.0)
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter + eps
    return inter / union


def _ciou_term(pred, gt, iouk, eps: float = 1e-10):
    """DIoU + CIoU penalty (reference iou_losses.py:100-133)."""
    x1, y1, x2, y2 = pred
    x1g, y1g, x2g, y2g = gt
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w = (x2 - x1) + ((x2 - x1) == 0).to(x1.dtype)
    h = (y2 - y1) + ((y2 - y1) == 0).to(y1.dtype)
    cxg, cyg = (x1g + x2g) / 2, (y1g + y2g) / 2
    wg, hg = x2g - x1g, y2g - y1g
    xc1, yc1 = torch.minimum(x1, x1g), torch.minimum(y1, y1g)
    xc2, yc2 = torch.maximum(x2, x2g), torch.maximum(y2, y2g)
    dist_inter = (cx - cxg) ** 2 + (cy - cyg) ** 2
    dist_union = (xc2 - xc1) ** 2 + (yc2 - yc1) ** 2
    diou = (dist_inter + eps) / (dist_union + eps)
    arctan = torch.atan(wg / hg) - torch.atan(w / h)
    ar_loss = 4.0 / (math.pi ** 2) * arctan * arctan
    alpha = (ar_loss / torch.clamp_min(1.0 - iouk + ar_loss, eps)).detach()
    return diou + alpha * ar_loss


class IouLoss:
    """loss = (1 - iou^2) * weight, optional CIoU term (iou_losses.py:15-133)."""

    def __init__(self, loss_weight=2.5, max_height=608, max_width=608,
                 ciou_term=False, loss_square=True):
        self.loss_weight = loss_weight
        self.loss_square = loss_square
        self.ciou_term = ciou_term

    def __call__(self, x, y, w, h, tx, ty, tw, th, anchors_wh, downsample, scale_x_y):
        pred = _bbox_transform(x, y, w, h, anchors_wh, downsample, scale_x_y, is_gt=False)
        gt = _bbox_transform(tx, ty, tw, th, anchors_wh, downsample, scale_x_y, is_gt=True)
        iouk = _elementwise_iou(pred, gt)
        if self.ciou_term:
            iouk = iouk - _ciou_term(pred, gt, iouk)
        loss = 1.0 - iouk * iouk if self.loss_square else 1.0 - iouk
        return loss * self.loss_weight


class IouAwareLoss(IouLoss):
    """BCE of the predicted IoU against the (detached) actual IoU
    (iou_losses.py:194-246)."""

    def __init__(self, loss_weight=1.0, max_height=608, max_width=608):
        super().__init__(loss_weight=loss_weight)

    def __call__(self, ioup_logit, x, y, w, h, tx, ty, tw, th, anchors_wh,
                 downsample, scale_x_y):
        pred = _bbox_transform(x, y, w, h, anchors_wh, downsample, scale_x_y, is_gt=False)
        gt = _bbox_transform(tx, ty, tw, th, anchors_wh, downsample, scale_x_y, is_gt=True)
        iouk = _elementwise_iou(pred, gt).detach()
        nlog_ioup = torch.clamp_max(F.softplus(-ioup_logit), _EPS_CAP)
        return iouk * nlog_ioup * self.loss_weight


class YOLOv3Loss:
    """Combined fine-grained loss (reference losses.py:85-241)."""

    def __init__(self, ignore_thresh=0.7, label_smooth=True,
                 use_fine_grained_loss=True, iou_loss: Optional[IouLoss] = None,
                 iou_aware_loss: Optional[IouAwareLoss] = None,
                 downsample: Sequence[int] = (32, 16, 8), scale_x_y=1.0,
                 match_score=False):
        self.ignore_thresh = ignore_thresh
        self.iou_loss = iou_loss
        self.iou_aware_loss = iou_aware_loss
        self.downsample = list(downsample)
        self.scale_x_y = scale_x_y
        self.match_score = match_score

    def __call__(self, outputs: List[torch.Tensor], targets: List[torch.Tensor],
                 gt_box: torch.Tensor, mask_anchors: List[List[float]],
                 num_classes: int) -> Dict[str, torch.Tensor]:
        assert len(outputs) == len(targets)
        # the loss math runs in fp32 whatever the forward's dtype
        outputs = [o.float().permute(0, 2, 3, 1) for o in outputs]
        losses: Dict[str, torch.Tensor] = {}

        def add(name, v):
            losses[name] = losses[name] + v if name in losses else v

        for i, (output, target) in enumerate(zip(outputs, targets)):
            downsample = self.downsample[i]
            anchors_wh = torch.tensor(mask_anchors[i], dtype=torch.float32,
                                      device=output.device).reshape(-1, 2)
            an = anchors_wh.shape[0]
            n, s = output.shape[:2]
            scale_x_y = (self.scale_x_y if not isinstance(self.scale_x_y, (list, tuple))
                         else self.scale_x_y[i])
            ioup_logit = None
            if self.iou_aware_loss is not None:
                ioup_logit = output[..., :an]
                output = output[..., an:]
            out = output.reshape(n, s, s, an, 5 + num_classes)
            x, y, w, h, obj = out.unbind(-1)[:5]
            cls = out[..., 5:]
            tx, ty, tw, th, tscale, tobj = target[..., :6].unbind(-1)
            tcls = target[..., 6:]
            tscale_tobj = tscale * tobj

            if abs(scale_x_y - 1.0) < 1e-10:
                loss_x = _bce_logits(x, tx) * tscale_tobj
                loss_y = _bce_logits(y, ty) * tscale_tobj
            else:
                dx = scale_x_y * torch.sigmoid(x) - 0.5 * (scale_x_y - 1.0)
                dy = scale_x_y * torch.sigmoid(y) - 0.5 * (scale_x_y - 1.0)
                loss_x = torch.abs(dx - tx) * tscale_tobj
                loss_y = torch.abs(dy - ty) * tscale_tobj
            loss_w = torch.abs(w - tw) * tscale_tobj
            loss_h = torch.abs(h - th) * tscale_tobj
            add("loss_xy", (loss_x + loss_y).sum((1, 2, 3)).mean())
            add("loss_wh", (loss_w + loss_h).sum((1, 2, 3)).mean())
            if self.iou_loss is not None:
                li = self.iou_loss(x, y, w, h, tx, ty, tw, th, anchors_wh,
                                   downsample, scale_x_y) * tscale_tobj
                add("loss_iou", li.sum((1, 2, 3)).mean())
            if self.iou_aware_loss is not None:
                la = self.iou_aware_loss(ioup_logit, x, y, w, h, tx, ty, tw, th,
                                         anchors_wh, downsample, scale_x_y) * tobj
                add("loss_iou_aware", la.sum((1, 2, 3)).mean())
            pos, neg = self._obj_loss(x, y, w, h, obj, tobj, gt_box, anchors_wh,
                                      downsample, scale_x_y, cls)
            add("loss_obj", (pos + neg).mean())
            loss_cls = _bce_logits(cls, tcls).sum(-1) * tobj
            add("loss_cls", loss_cls.sum((1, 2, 3)).mean())
        order = ["loss_xy", "loss_wh", "loss_obj", "loss_cls", "loss_iou", "loss_iou_aware"]
        return {k: losses[k] for k in order if k in losses}

    def _obj_loss(self, x, y, w, h, obj, tobj, gt_box, anchors_wh, downsample,
                  scale_x_y, cls):
        """Objectness with the IoU-ignore mask (reference losses.py:292-356)."""
        n, s, _, an = x.shape
        px1, py1, px2, py2 = _bbox_transform(x, y, w, h, anchors_wh, downsample,
                                             scale_x_y, is_gt=False)
        pred = torch.stack([px1, py1, px2, py2], -1).reshape(n, s * s * an, 4).detach()
        gt_box = gt_box.float()
        gx, gy, gw, gh = gt_box.unbind(-1)
        gt = torch.stack([gx - gw / 2, gy - gh / 2, gx + gw / 2, gy + gh / 2], -1)
        max_iou = pairwise_iou(pred, gt).amax(-1)                   # [N, A]
        iou_mask = (max_iou <= self.ignore_thresh).float()
        if self.match_score:
            prob = torch.sigmoid(obj)[..., None] * torch.sigmoid(cls)
            max_prob = prob.reshape(n, s * s * an, -1).amax(-1)
            iou_mask = iou_mask * (max_prob <= 0.25).float()
        iou_mask = iou_mask.reshape(n, s, s, an).detach()
        obj_mask = (tobj > 0.0).float()
        noobj_mask = (1.0 - obj_mask) * iou_mask
        nlog_sig = torch.clamp_max(F.softplus(-obj), _EPS_CAP)
        nlog_one_minus = torch.clamp_max(F.softplus(obj), _EPS_CAP)
        pos = (tobj * nlog_sig).sum((1, 2, 3))
        neg = (noobj_mask * nlog_one_minus).sum((1, 2, 3))
        return pos, neg


def total_loss(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of all components (reference train.py:428-434)."""
    return sum(loss_dict.values())
