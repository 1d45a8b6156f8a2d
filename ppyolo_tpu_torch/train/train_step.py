"""The PP-YOLO train step: forward, loss, backward, SGD, EMA, BN stats.

Counterpart of ``ppyolo_tpu/train/train_step.py`` (``TrainState``,
``init_train_state``, ``make_target_builder``, ``make_train_step``,
``make_multi_train_step``).  JAX threads an immutable state through a
jitted function; here the state is mutable: the model holds the fp32
masters and the BN running stats (updated in place by the train-mode
forward), the optimizer holds the velocity, the EMA shadow is a flat dict,
and a 0-d device tensor counts the steps beside the host's count.

Everything a step reads changes on the device only: the LR and the EMA
decay come from the device step counter, the momentum buffers exist from
the start, constants are made once, and the gradients are returned by
``torch.autograd.grad`` (no ``.grad`` state outlives a step).  So the same
step function runs eagerly and inside a CUDA graph (``train/graphs.py``),
and both do the same work.

Mixed precision as in the JAX package: the forward runs on ``.to(bf16)``
copies of every parameter (``torch.func.functional_call``), so gradients
flow through the casts back to the fp32 masters; the BN running stats are
not cast (they stay the module's fp32 buffers).  Targets are built on the
device outside the autograd graph; uint8 images are normalized on the
device.

Under a process group (``parallel/dist.py``) each rank steps on its own
batch: the gradients and the loss terms are averaged over the ranks in
one all-reduce (``train_step.py:167-169``), every rank applies the same
update, and DropBlock's generator is seeded alike on every rank (JAX
replicates the rng, ``mesh.py:67-72``), so every replica draws the same
mask.  ``train_cfg['remat']`` recomputes the backbone's activations in the
backward (``ops/module.py::checkpointed``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.func import functional_call

from ..data.targets import gt2yolo_targets_device
from ..ops.ema import ema_update
from ..ops.module import device_constant
from ..parallel import dist
from .losses import IouAwareLoss, IouLoss, YOLOv3Loss, total_loss
from .lr_schedule import DeviceLR
from .optimizer import SGD

GT_KEYS = ("gt_bbox", "gt_class", "gt_score")
TARGET_PIPELINES = ("step", "prescan", "doublebuf")


@dataclasses.dataclass
class TrainState:
    """model: fp32 masters + BN running stats; optimizer: SGD whose momentum
    buffers are the velocity; ema: flat shadow of the trainable leaves (or
    None); step: steps taken (host); step_t: the same count as a 0-d int64
    tensor on the model's device, which the steps read and advance;
    trainable: {path: parameter} in the optimizer."""

    model: torch.nn.Module
    optimizer: SGD
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    trainable: Dict[str, torch.nn.Parameter]
    step_t: torch.Tensor

    def velocity(self) -> Dict[str, torch.Tensor]:
        return dict(self.optimizer.bufs)

    def set_step(self, step: int) -> None:
        """Both counters to ``step`` (resume)."""
        self.step = int(step)
        self.step_t.fill_(int(step))

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor a step changes, by a name of its own: parameters and
        BN statistics, momentum buffers, the EMA shadow and the step."""
        out = {f"model/{k}": v for k, v in self.model.state_dict(keep_vars=True).items()}
        out.update({f"velocity/{k}": v for k, v in self.optimizer.bufs.items()})
        out.update({f"ema/{k}": v for k, v in (self.ema or {}).items()})
        out["step"] = self.step_t
        return {k: v.detach() for k, v in out.items()}


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
    opt = SGD(trainable, flat_policy,
              momentum=cfg.optimizerBuilder["optimizer"]["momentum"],
              l2_factor=cfg.optimizerBuilder["regularizer"]["factor"])
    ema = ({k: p.detach().clone() for k, p in trainable.items()}
           if getattr(cfg, "use_ema", False) else None)
    dev = next(model.parameters()).device
    return TrainState(model, opt, ema, 0, trainable,
                      torch.zeros((), dtype=torch.int64, device=dev))


def make_target_builder(cfg):
    """``batch -> per-level targets``: the batch's own 'targets' when the
    host built them, else built on the device from its gt arrays.  The
    builder works image by image, so one call at [n*B] equals n calls at
    [B] bit for bit (the 'prescan' pipeline)."""
    tcfg = dict(cfg.gt2YoloTarget)

    def batch_targets(batch):
        if "targets" in batch:
            return list(batch["targets"])
        h, w = batch["image"].shape[1:3]
        return gt2yolo_targets_device(
            batch["gt_bbox"], batch["gt_class"], batch["gt_score"], (h, w),
            tcfg["anchors"], tcfg["anchor_masks"], tcfg["downsample_ratios"],
            tcfg["num_classes"], iou_thresh=tcfg.get("iou_thresh", 1.0))

    return batch_targets


def make_train_step(model: torch.nn.Module, cfg, *,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: Optional[bool] = None):
    """Returns ``step_fn(state, batch, generator=None) -> (state, losses)``.

    batch (tensors on the model's device): 'image' [N,H,W,3] uint8 (or
    normalized float), 'gt_bbox' [N,50,4] normalized xywh, and either
    'targets' (per-level [N,S,S,an,6+C]) or 'gt_class' / 'gt_score' for the
    device-side builder.  ``generator`` feeds DropBlock.  losses holds the
    loss terms, 'total_loss' and 'lr' (0-d device tensors), averaged over
    the ranks when a process group is initialised.  ``remat`` (default
    ``cfg.train_cfg['remat']``, off) checkpoints the backbone."""
    if remat is None:
        remat = bool(cfg.train_cfg.get("remat", False))
    loss_obj = build_loss(cfg)
    lr_cfg = cfg.learningRate
    device_lr: Dict[torch.device, DeviceLR] = {}
    use_ema = getattr(cfg, "use_ema", False)
    ema_decay = getattr(cfg, "ema_decay", 0.9998)
    num_classes = cfg.head["num_classes"]
    mask_anchors = model.head.mask_anchors
    batch_targets = make_target_builder(cfg)
    norm = getattr(cfg, "normalizeImage", None) or {}
    mean = tuple(norm.get("mean", (0.0, 0.0, 0.0)))
    std = tuple(norm.get("std", (1.0, 1.0, 1.0)))
    is_scale = bool(norm.get("is_scale", True))
    if (getattr(cfg, "permute", None) or {}).get("to_bgr", False):
        # the loader flips the channels before the uint8 ship
        mean, std = mean[::-1], std[::-1]

    def prep_images(raw: torch.Tensor) -> torch.Tensor:
        """NHWC -> NCHW (channels_last memory) in the compute dtype; uint8
        normalized on the device as ``train_step.py:111-118``."""
        x = raw.permute(0, 3, 1, 2)
        if raw.dtype != torch.uint8:
            return x.to(compute_dtype)
        x = x.float()
        if is_scale:
            x = x * (1.0 / 255.0)
        m = device_constant(mean, torch.float32, x.device).view(1, 3, 1, 1)
        sd = device_constant(std, torch.float32, x.device).view(1, 3, 1, 1)
        return ((x - m) / sd).to(compute_dtype)

    def step_fn(state: TrainState, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None):
        m = state.model
        m.train()
        with torch.no_grad():
            targets = batch_targets(batch)
        images = prep_images(batch["image"])
        if compute_dtype == torch.float32:
            outputs = m(images, generator, remat)
        else:
            cast = {k: p.to(compute_dtype) for k, p in m.named_parameters()}
            outputs = functional_call(m, cast, (images,),
                                      {"generator": generator, "remat": remat})
        losses = loss_obj(outputs, targets, batch["gt_bbox"], mask_anchors, num_classes)
        total = total_loss(losses)
        keys = list(state.trainable)
        grads = torch.autograd.grad(total, [state.trainable[k] for k in keys],
                                    allow_unused=True)
        # the JAX grad of an unused leaf is 0
        grads = [torch.zeros_like(state.trainable[k]) if g is None else g
                 for k, g in zip(keys, grads)]
        if dist.active():
            names = list(losses)
            reduced = dist.all_reduce_mean(grads + [losses[k].detach() for k in names])
            grads = reduced[:len(grads)]
            losses = dict(zip(names, reduced[len(grads):]))
            total = total_loss(losses)   # JAX sums the averaged terms again
        grads = dict(zip(keys, grads))
        dev = state.step_t.device
        if dev not in device_lr:
            device_lr[dev] = DeviceLR(lr_cfg, dev)
        lr_t = device_lr[dev](state.step_t)
        state.optimizer.step(grads, lr_t)
        if use_ema and state.ema is not None:
            ema_update(state.ema, state.trainable, state.step_t, ema_decay)
        state.step_t.add_(1)
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        out["lr"] = lr_t
        return state, out

    return step_fn


def make_multi_train_step(model: torch.nn.Module, cfg, *, n_steps: int,
                          compute_dtype: torch.dtype = torch.float32,
                          target_pipeline: Optional[str] = None):
    """``n_steps`` train steps as one unit of work (the JAX ``lax.scan`` of
    ``train_step.py:194-274``; on the card ``train/graphs.py`` replays the
    unit as one CUDA graph).

    target_pipeline (default ``cfg.train_cfg['target_pipeline']``, 'step')
    says where the device-side target build runs, with bitwise-equal
    results in every mode:
      'step'      before each step's forward;
      'prescan'   one build over all ``n_steps * B`` images first, then
                  each step takes its slice;
      'doublebuf' step i takes the targets built after step i-1 (batch 0's
                  before the first step).  JAX's scan also builds a wasted
                  set for batch 0 after the last step; here it is not built.

    Returns ``fn(state, batches, generator=None) -> (state, stacked_losses)``
    where every tensor of ``batches`` has a leading ``n_steps`` axis and each
    loss is stacked to ``[n_steps]``."""
    step = make_train_step(model, cfg, compute_dtype=compute_dtype)
    build = make_target_builder(cfg)
    if target_pipeline is None:
        target_pipeline = cfg.train_cfg.get("target_pipeline", "step")
    if target_pipeline not in TARGET_PIPELINES:
        raise ValueError(f"target_pipeline {target_pipeline!r} not in {TARGET_PIPELINES}")

    def targets_of(batch):
        with torch.no_grad():
            return tuple(build(batch))

    def multi(state: TrainState, batches: Dict[str, Any],
              generator: Optional[torch.Generator] = None):
        mode = target_pipeline if "targets" not in batches else "step"
        per_step = [{k: (tuple(t[i] for t in v) if k == "targets" else v[i])
                     for k, v in batches.items()} for i in range(n_steps)]
        if mode == "prescan":
            flat = {k: batches[k].reshape((-1,) + batches[k].shape[2:]) for k in GT_KEYS}
            image = batches["image"][0]
            tg = targets_of({"image": image, **flat})
            tg = [t.reshape((n_steps, -1) + t.shape[1:]) for t in tg]
            for i, b in enumerate(per_step):
                b["targets"] = tuple(t[i] for t in tg)
        records = []
        nxt = targets_of(per_step[0]) if mode == "doublebuf" else None
        for i, b in enumerate(per_step):
            if mode == "doublebuf":
                b["targets"] = nxt
            state, losses = step(state, b, generator)
            records.append(losses)
            if mode == "doublebuf" and i + 1 < n_steps:
                nxt = targets_of(per_step[i + 1])
        return state, {k: torch.stack([r[k] for r in records]) for k in records[0]}

    return multi
