"""Plain PyTorch reference of the PP-YOLO fine-tuning step, and the
readings that judge the program's first steps against it.

A step: YOLOv3 targets from the ground truth (best anchor by wh-IoU, the
later ground truth winning a cell's fields, classes multi-hot), the
train-mode forward of ``model.Net`` (batch statistics; DropBlock from
uniforms drawn by a generator seeded as the program's, in the same order
and shapes), the fine-grained loss (Grid-Sensitive L1 xy, L1 wh, IoU,
IoU-aware, objectness with the ignore mask, per-class BCE: the loss
formulas below are a frozen copy of the program's plain ones), the
gradients by autograd in fp32, then momentum SGD with the L2 regularizer
(no decay on norms and biases) at the warmup / piecewise LR of the step,
then the EMA shadow of the trainable leaves (``decay_t = min(decay,
(1 + t) / (10 + t))``); the forward updates the BN running statistics
(momentum 0.1, unbiased variance).

``quant="fp8"`` rounds every conv's input and weight to float8 e4m3 with
a per-tensor scale, and the gradients that reach them to e5m2: the
lower-precision control of a bf16 training cell.  ``quant="bf16"`` rounds
the same operands and gradients to bf16, as the program's bf16 step
does: the witness of what bf16 rounding alone does to each reading.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref

_EPS_CAP = 20.72326583694641  # -log(1e-9)


def targets(cfg, gt_bbox: np.ndarray, gt_class: np.ndarray, gt_score: np.ndarray,
            hw, device) -> List[torch.Tensor]:
    """Per level [B, gh, gw, an, 6 + C]: tx, ty, tw, th, tscale, score and
    the multi-hot classes."""
    t = cfg["gt2YoloTarget"]
    h, w = hw
    nc = t["num_classes"]
    anchors = np.asarray(t["anchors"], np.float32)
    f = np.float32
    out = []
    for mask, ds in zip(t["anchor_masks"], t["downsample_ratios"]):
        out.append(np.zeros((gt_bbox.shape[0], h // ds, w // ds, len(mask), 6 + nc), np.float32))
    for b in range(gt_bbox.shape[0]):
        for m in range(gt_bbox.shape[1]):
            gx, gy, gw, gh = (f(v) for v in gt_bbox[b, m])
            score = f(gt_score[b, m])
            if not (gw > 0 and gh > 0 and score > 0):
                continue
            aw, ah = anchors[:, 0] / f(w), anchors[:, 1] / f(h)
            inter = np.minimum(gw, aw) * np.minimum(gh, ah)
            best = int(np.argmax(inter / np.maximum(gw * gh + aw * ah - inter, f(1e-12))))
            for lvl, (mask, ds) in enumerate(zip(t["anchor_masks"], t["downsample_ratios"])):
                if best not in mask:
                    continue
                a = mask.index(best)
                gridh, gridw = h // ds, w // ds
                gi = min(max(int(gx * f(gridw)), 0), gridw - 1)
                gj = min(max(int(gy * f(gridh)), 0), gridh - 1)
                row = out[lvl][b, gj, gi, a]
                row[:6] = [gx * f(gridw) - f(gi), gy * f(gridh) - f(gj),
                           np.log(gw * f(w) / anchors[best, 0]),
                           np.log(gh * f(h) / anchors[best, 1]), f(2.0) - gw * gh, score]
                c = int(gt_class[b, m])
                if 0 <= c < nc:
                    row[6 + c] = 1.0
    return [torch.from_numpy(o).to(device) for o in out]


def _bce_logits(logit, target):
    pos = torch.clamp_max(F.softplus(-logit), _EPS_CAP)
    neg = torch.clamp_max(F.softplus(logit), _EPS_CAP)
    return target * pos + (1.0 - target) * neg


def _decode(dx, dy, dw, dh, anchors_wh, downsample, sxy, is_gt):
    s = dx.shape[1]
    gx = torch.arange(s, dtype=dx.dtype, device=dx.device)[None, None, :, None]
    gy = torch.arange(s, dtype=dx.dtype, device=dx.device)[None, :, None, None]
    if is_gt:
        cx, cy = (dx + gx) / s, (dy + gy) / s
    else:
        sx, sy = torch.sigmoid(dx), torch.sigmoid(dy)
        if abs(sxy - 1.0) > 1e-10:
            sx, sy = sxy * sx - 0.5 * (sxy - 1.0), sxy * sy - 0.5 * (sxy - 1.0)
        cx, cy = (sx + gx) / s, (sy + gy) / s
    pw = torch.exp(dw) * anchors_wh[:, 0] / (s * downsample)
    ph = torch.exp(dh) * anchors_wh[:, 1] / (s * downsample)
    out = (cx - 0.5 * pw, cy - 0.5 * ph, cx + 0.5 * pw, cy + 0.5 * ph)
    return tuple(v.detach() for v in out) if is_gt else out


def _iou(p, g, eps=1e-10):
    x1, y1, x2, y2 = p
    x1g, y1g, x2g, y2g = g
    x2, y2 = torch.maximum(x1, x2), torch.maximum(y1, y2)
    inter = (torch.minimum(x2, x2g) - torch.maximum(x1, x1g)).clamp_min(0) * \
        (torch.minimum(y2, y2g) - torch.maximum(y1, y1g)).clamp_min(0)
    return inter / ((x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter + eps)


def loss(cfg, outputs: List[torch.Tensor], tgts: List[torch.Tensor],
         gt_box: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fine-grained YOLOv3 loss terms (fp32), each summed over cells and
    averaged over images."""
    h = cfg["head"]
    nc = h["num_classes"]
    sxy = cfg["yolo_loss"]["scale_x_y"]
    if abs(sxy - 1.0) < 1e-10:
        raise NotImplementedError("the BCE xy loss of scale_x_y == 1")
    iou_w = cfg["iou_loss"]["loss_weight"] if cfg.get("iou_loss_type") else None
    aware_w = cfg["iou_aware_loss"]["loss_weight"] if cfg.get("iou_aware_loss_type") else None
    ignore = cfg["yolo_loss"]["ignore_thresh"]
    out: Dict[str, torch.Tensor] = {}

    def add(k, v):
        out[k] = out[k] + v if k in out else v

    g = gt_box.float()
    gt = torch.stack([g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2,
                      g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2], -1)
    for i, (o, t) in enumerate(zip(outputs, tgts)):
        o = o.float().permute(0, 2, 3, 1)
        mask = h["anchor_masks"][i]
        an = len(mask)
        anc = torch.tensor([h["anchors"][a] for a in mask], dtype=torch.float32, device=o.device)
        ds = h["downsample"][i]
        n, s = o.shape[:2]
        ioup = None
        if aware_w is not None:
            ioup, o = o[..., :an], o[..., an:]
        o = o.reshape(n, s, s, an, 5 + nc)
        x, y, w, hh, obj = o.unbind(-1)[:5]
        cls = o[..., 5:]
        tx, ty, tw, th, tscale, tobj = t[..., :6].unbind(-1)
        wgt = tscale * tobj
        dx = sxy * torch.sigmoid(x) - 0.5 * (sxy - 1.0)
        dy = sxy * torch.sigmoid(y) - 0.5 * (sxy - 1.0)
        add("loss_xy", ((dx - tx).abs() * wgt + (dy - ty).abs() * wgt).sum((1, 2, 3)).mean())
        add("loss_wh", ((w - tw).abs() * wgt + (hh - th).abs() * wgt).sum((1, 2, 3)).mean())
        pred = _decode(x, y, w, hh, anc, ds, sxy, False)
        tbox = _decode(tx, ty, tw, th, anc, ds, sxy, True)
        iouk = _iou(pred, tbox)
        if iou_w is not None:
            add("loss_iou", ((1 - iouk * iouk) * iou_w * wgt).sum((1, 2, 3)).mean())
        if aware_w is not None:
            la = iouk.detach() * torch.clamp_max(F.softplus(-ioup), _EPS_CAP) * aware_w * tobj
            add("loss_iou_aware", la.sum((1, 2, 3)).mean())
        pb = torch.stack(pred, -1).reshape(n, s * s * an, 4).detach()
        max_iou = ref.pairwise_iou(pb, gt).amax(-1).reshape(n, s, s, an)
        noobj = (1.0 - (tobj > 0).float()) * (max_iou <= ignore).float()
        pos = (tobj * torch.clamp_max(F.softplus(-obj), _EPS_CAP)).sum((1, 2, 3))
        neg = (noobj * torch.clamp_max(F.softplus(obj), _EPS_CAP)).sum((1, 2, 3))
        add("loss_obj", (pos + neg).mean())
        add("loss_cls", (_bce_logits(cls, t[..., 6:]).sum(-1) * tobj).sum((1, 2, 3)).mean())
    return out


def lr_at(cfg, step: int) -> float:
    lr = cfg["learningRate"]
    warm = lr["LinearWarmup"]
    passed = sum(step >= m for m in lr["PiecewiseDecay"]["milestones"])
    if step <= warm["steps"] and passed == 0:
        sf = warm["start_factor"]
        return lr["base_lr"] * (sf + (1.0 - sf) / warm["steps"] * step)
    return lr["base_lr"] * lr["PiecewiseDecay"]["gamma"] ** passed


def trainable(P: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in P if not k.endswith(("running_mean", "running_var"))]


def decays(k: str) -> bool:
    """L2 on conv weights (and the DCN offset conv's bias), not on norms
    and the output convs' biases."""
    return ".bn." not in k and not k.endswith(".conv.bias")


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-tensor scaled rounding to a float8 type (its largest finite value
    at the tensor's abs-max)."""
    scale = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-12)
    return (t * scale).to(dtype).to(t.dtype) / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# (forward rounding of a conv's operands, rounding of the gradient that reaches them)
ROUNDINGS = {"fp8": (lambda t: _fp8(t, torch.float8_e4m3fn), lambda g: _fp8(g, torch.float8_e5m2)),
             "bf16": (_bf16, _bf16)}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return ROUNDINGS[kind][0](t)

    @staticmethod
    def backward(ctx, g):
        return ROUNDINGS[ctx.kind][1](g), None


def rounding(kind: Optional[str]):
    """The rounding of every conv's operands for ``quant`` (None: fp32)."""
    return None if kind is None else (lambda t: _Round.apply(t, kind))


def ema_decay_at(step: int, decay: float) -> float:
    """``min(decay, (1 + step) / (10 + step))`` in fp32."""
    t = np.float32(step)
    return float(np.minimum(np.float32(decay), (np.float32(1) + t) / (np.float32(10) + t)))


def steps(cfg, P0: Dict[str, torch.Tensor], batches: List[dict], *, drop_seed: int,
          device, n: int = 3, quant: Optional[str] = None, half_batch: bool = False,
          ema: bool = True) -> dict:
    """``n`` reference steps from ``P0`` (not modified) on ``batches``.
    Returns {"loss": [total per step], "grad": {leaf: |the optimizer's
    first gradient|}, "step": {leaf: |p_n - p_0|}, "ema": {leaf: |shadow_n
    - p_0|} (empty without ``cfg["use_ema"]``), "bn": {running statistic:
    |r_n - r_0|}}.  ``ema=False`` leaves the shadow unchanged (a fault)."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    keys = trainable(P)
    for k in keys:
        P[k].requires_grad_(True)
    vel = {k: torch.zeros_like(P[k]) for k in keys}
    shadow = {k: P0[k].clone() for k in keys} if cfg.get("use_ema") else {}
    mom = cfg["optimizerBuilder"]["optimizer"]["momentum"]
    l2 = cfg["optimizerBuilder"]["regularizer"]["factor"]
    gen = torch.Generator(device=device).manual_seed(drop_seed)
    drop = lambda shape: torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    out = {"loss": [], "grad": {}}
    with ref.fp32_exact():
        for i in range(n):
            b = batches[i % len(batches)]   # the feed cycles its pool
            if half_batch:
                b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
            img = torch.from_numpy(b["image"]).to(device)
            tg = targets(cfg, b["gt_bbox"], b["gt_class"], b["gt_score"], img.shape[1:3], device)
            net = ref.Net(cfg, P, mode="train", drop_uniform=drop, quant=rounding(quant))
            terms = loss(cfg, net(ref.normalize(cfg, img)), tg,
                         torch.from_numpy(b["gt_bbox"]).to(device))
            total = sum(terms.values())
            grads = torch.autograd.grad(total, [P[k] for k in keys], allow_unused=True)
            grads = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(keys, grads)]
            out["loss"].append(float(total.detach()))
            lr = lr_at(cfg, i)
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    if decays(k):
                        g = g + l2 * P[k]
                    vel[k].mul_(mom).add_(g)
                    P[k].sub_(lr * vel[k])
                if ema:
                    d = ema_decay_at(i, cfg.get("ema_decay", 0.9998))
                    for k, v in shadow.items():
                        v.mul_(d).add_(P[k] * (1.0 - d))
            if i == 0:
                out["grad"] = {k: float(vel[k].norm()) for k in keys}
    with torch.no_grad():
        change = lambda now, ks: {k: float((now[k] - P0[k]).norm()) for k in ks}
        out["step"] = change(P, keys)
        out["ema"] = change(shadow, list(shadow))
        out["bn"] = change(P, [k for k in P if k.endswith(("running_mean", "running_var"))])
    return out


def leaf_gaps(prog: Dict[str, float], refr: Dict[str, float], keys) -> Dict[str, float]:
    """{leaf: |program's norm - reference's| over the larger of the
    reference's norm of that leaf and of the median leaf}."""
    med = float(np.median([refr[k] for k in keys]))
    return {k: abs(prog[k] - refr[k]) / max(refr[k], med) for k in keys}


def readings(prog: dict, refr: dict, rule: float = 1e-3) -> Dict[str, object]:
    """The median leaf's gap (compared) and the worst leaf's (reported,
    with its name under "worst") of: the optimizer's first gradient
    (``grad``), the parameters' change after the steps (``step``), the EMA
    shadow's change (``ema``) and the BN running statistics' change
    (``bn``); ``step_gap_total``, the gap between the norms of the whole
    model's change over the reference's; ``loss_gap_max``, the largest
    step's loss gap over the reference's loss (reported).  Leaves whose
    reference gradient is under ``rule`` times the median leaf's are left
    out of grad, step and ema (they move under round-off alone)."""
    med_g = float(np.median(list(refr["grad"].values())))
    keys = [k for k, v in refr["grad"].items() if v >= rule * med_g]
    groups = {"grad": keys, "step": keys, "ema": keys if refr["ema"] else [],
              "bn": list(refr["bn"])}
    out: Dict[str, object] = {}
    worst = {}
    for name, ks in groups.items():
        if not ks:
            continue
        gaps = leaf_gaps(prog[name], refr[name], ks)
        out[f"{name}_gap_med"] = float(np.median(list(gaps.values())))
        leaf = max(gaps, key=gaps.get)
        out[f"{name}_gap_max"] = gaps[leaf]
        worst[name] = leaf
    rs = float(np.sqrt(sum(refr["step"][k] ** 2 for k in keys)))
    ps = float(np.sqrt(sum(prog["step"][k] ** 2 for k in keys)))
    out["step_gap_total"] = abs(ps - rs) / rs
    out["loss_gap_max"] = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], refr["loss"]))
    out["worst"] = worst
    return out
