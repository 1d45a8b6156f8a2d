"""The PP-YOLO train step: forward, loss, backward, SGD, EMA, BN stats.

Counterpart of ``ppyolo_tpu/train/train_step.py:26-191`` (``TrainState``,
``init_train_state``, ``make_train_step``).  JAX threads an immutable state
through a jitted function; here the state is mutable: the model holds the
fp32 masters and the BN running stats (updated in place by the train-mode
forward), the optimizer holds the velocity, the EMA shadow is a flat dict.

Mixed precision as in the JAX package: the forward runs on ``.to(bf16)``
copies of every parameter (``torch.func.functional_call``), so gradients
flow through the casts back to the fp32 masters; the BN running stats are
not cast (they stay the module's fp32 buffers).  Targets are built on the
device outside the graph; uint8 images are normalized on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.func import functional_call

from ..data.targets import gt2yolo_targets_device
from ..ops.ema import ema_update
from .losses import IouAwareLoss, IouLoss, YOLOv3Loss, total_loss
from .lr_schedule import make_lr_fn
from .optimizer import make_sgd, set_lr


@dataclasses.dataclass
class TrainState:
    """model: fp32 masters + BN running stats; optimizer: SGD whose momentum
    buffers are the velocity; ema: flat shadow of the trainable leaves (or
    None); step: steps taken; trainable: {path: parameter} in the optimizer."""

    model: torch.nn.Module
    optimizer: torch.optim.SGD
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    trainable: Dict[str, torch.nn.Parameter]

    def velocity(self) -> Dict[str, torch.Tensor]:
        st = self.optimizer.state
        return {k: st[p]["momentum_buffer"] if "momentum_buffer" in st.get(p, {})
                else torch.zeros_like(p) for k, p in self.trainable.items()}


def build_loss(cfg) -> YOLOv3Loss:
    iou_loss = IouLoss(**cfg.iou_loss) if cfg.iou_loss_type else None
    iou_aware_loss = (IouAwareLoss(**cfg.iou_aware_loss)
                      if getattr(cfg, "iou_aware_loss_type", None) else None)
    yl = dict(cfg.yolo_loss)
    yl.pop("use_fine_grained_loss", None)
    return YOLOv3Loss(iou_loss=iou_loss, iou_aware_loss=iou_aware_loss,
                      downsample=cfg.head["downsample"], **yl)


def init_train_state(model: torch.nn.Module, cfg) -> TrainState:
    """Optimizer over the trainable leaves (``model.flat_policy()``) and,
    with ``cfg.use_ema``, an EMA shadow that copies them."""
    flat_policy = model.flat_policy()
    trainable = {k: p for k, p in model.named_parameters() if flat_policy[k].trainable}
    opt = make_sgd(trainable, flat_policy,
                   momentum=cfg.optimizerBuilder["optimizer"]["momentum"],
                   l2_factor=cfg.optimizerBuilder["regularizer"]["factor"])
    ema = ({k: p.detach().clone() for k, p in trainable.items()}
           if getattr(cfg, "use_ema", False) else None)
    return TrainState(model, opt, ema, 0, trainable)


def make_train_step(model: torch.nn.Module, cfg, *,
                    compute_dtype: torch.dtype = torch.float32):
    """Returns ``step_fn(state, batch, generator=None) -> (state, losses)``.

    batch (tensors on the model's device): 'image' [N,H,W,3] uint8 (or
    normalized float), 'gt_bbox' [N,50,4] normalized xywh, and either
    'targets' (per-level [N,S,S,an,6+C]) or 'gt_class' / 'gt_score' for the
    device-side builder.  ``generator`` feeds DropBlock.  losses holds the
    loss terms, 'total_loss' (device tensors) and 'lr' (a float)."""
    loss_obj = build_loss(cfg)
    lr_fn = make_lr_fn(cfg.learningRate)
    use_ema = getattr(cfg, "use_ema", False)
    ema_decay = getattr(cfg, "ema_decay", 0.9998)
    num_classes = cfg.head["num_classes"]
    mask_anchors = model.head.mask_anchors
    tcfg = dict(cfg.gt2YoloTarget)
    norm = getattr(cfg, "normalizeImage", None) or {}
    mean = torch.tensor(norm.get("mean", (0.0, 0.0, 0.0)), dtype=torch.float32)
    std = torch.tensor(norm.get("std", (1.0, 1.0, 1.0)), dtype=torch.float32)
    is_scale = bool(norm.get("is_scale", True))
    if (getattr(cfg, "permute", None) or {}).get("to_bgr", False):
        # the loader flips the channels before the uint8 ship
        mean, std = mean.flip(0), std.flip(0)

    def prep_images(raw: torch.Tensor) -> torch.Tensor:
        """NHWC -> NCHW (channels_last memory) in the compute dtype; uint8
        normalized on the device as ``train_step.py:111-118``."""
        x = raw.permute(0, 3, 1, 2)
        if raw.dtype != torch.uint8:
            return x.to(compute_dtype)
        x = x.float()
        if is_scale:
            x = x * (1.0 / 255.0)
        x = (x - mean.to(x.device).view(1, 3, 1, 1)) / std.to(x.device).view(1, 3, 1, 1)
        return x.to(compute_dtype)

    def batch_targets(batch):
        if "targets" in batch:
            return list(batch["targets"])
        h, w = batch["image"].shape[1:3]
        return gt2yolo_targets_device(
            batch["gt_bbox"], batch["gt_class"], batch["gt_score"], (h, w),
            tcfg["anchors"], tcfg["anchor_masks"], tcfg["downsample_ratios"],
            tcfg["num_classes"], iou_thresh=tcfg.get("iou_thresh", 1.0))

    def step_fn(state: TrainState, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None):
        m = state.model
        m.train()
        with torch.no_grad():
            targets = batch_targets(batch)
        images = prep_images(batch["image"])
        if compute_dtype == torch.float32:
            outputs = m(images, generator)
        else:
            cast = {k: p.to(compute_dtype) for k, p in m.named_parameters()}
            outputs = functional_call(m, cast, (images,), {"generator": generator})
        losses = loss_obj(outputs, targets, batch["gt_bbox"], mask_anchors, num_classes)
        total = total_loss(losses)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in state.trainable.values():   # the JAX grad of an unused leaf is 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr_t = lr_fn(state.step)
        set_lr(state.optimizer, lr_t)
        state.optimizer.step()
        if use_ema and state.ema is not None:
            ema_update(state.ema, state.trainable, state.step, ema_decay)
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        out["lr"] = lr_t
        return state, out

    return step_fn
