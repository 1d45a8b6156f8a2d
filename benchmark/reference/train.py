"""Plain PyTorch fine-tuning step of the PP-YOLO family, and the readings
that judge the program's first steps against it.

A step, over the configuration's reference module ``ref``
(``reference/__init__.py``): ``ref.targets`` from the ground truth, the
train-mode forward of ``ref.Net`` (batch statistics; DropBlock from
uniforms drawn by a generator seeded as the program's, in the same order
and shapes), the loss terms of ``ref.loss``, the gradients by autograd in
fp32, then momentum SGD with the L2 regularizer (no decay on norms and
biases) at the warmup / piecewise LR of the step, then the EMA shadow of
the trainable leaves (``decay_t = min(decay, (1 + t) / (10 + t))``); the
forward updates the BN running statistics (momentum 0.1, unbiased
variance).

On ranks (``ranks=True``: each process of ``torch.distributed``'s default
group steps on its own batches from the same weights) every BN's
statistics are summed over the ranks by a plain fp32 all-reduce of its
``[Σx, Σx², count]`` (sync-BN; its backward sums every rank's gradient of
them), and the gradients and the loss are averaged over the ranks in one
more: the step of the whole group's batch, as the program's
``norm_type="sync_bn"`` data parallelism takes it.

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
import torch.distributed as dist


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


class _SumOverRanks(torch.autograd.Function):
    """A tensor summed over the ranks.  Every rank's loss depends on every
    rank's summand, so the gradient of a summand is the sum of every
    rank's gradient of the result."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def steps(ref, cfg, P0: Dict[str, torch.Tensor], batches: List[dict], *, drop_seed: int,
          device, n: int = 3, quant: Optional[str] = None, half_batch: bool = False,
          ema: bool = True, ranks: bool = False) -> dict:
    """``n`` steps of the reference module ``ref`` from ``P0`` (not
    modified) on ``batches``; with ``ranks`` this process's share of the
    group's step (module docstring).  Returns {"loss": [total per step],
    "grad": {leaf: |the optimizer's first gradient|}, "step": {leaf: |p_n
    - p_0|}, "ema": {leaf: |shadow_n - p_0|} (empty without
    ``cfg["use_ema"]``), "bn": {running statistic: |r_n - r_0|}}.
    ``ema=False`` leaves the shadow unchanged (a fault)."""
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
    sync = {"stats_sum": _SumOverRanks.apply} if ranks else {}
    out = {"loss": [], "grad": {}}
    with ref.fp32_exact():
        for i in range(n):
            b = batches[i % len(batches)]   # the feed cycles its pool
            if half_batch:
                b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
            img = torch.from_numpy(b["image"]).to(device)
            tg = ref.targets(cfg, b["gt_bbox"], b["gt_class"], b["gt_score"], img.shape[1:3],
                             device)
            net = ref.Net(cfg, P, mode="train", drop_uniform=drop, quant=rounding(quant), **sync)
            terms = ref.loss(cfg, net(ref.normalize(cfg, img)), tg,
                             torch.from_numpy(b["gt_bbox"]).to(device))
            total = sum(terms.values())
            grads = torch.autograd.grad(total, [P[k] for k in keys], allow_unused=True)
            grads = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(keys, grads)]
            total = total.detach()
            if ranks:
                flat = torch.cat([g.reshape(-1) for g in grads] + [total.reshape(1)])
                dist.all_reduce(flat)
                flat = flat / dist.get_world_size()
                parts = flat.split([g.numel() for g in grads] + [1])
                grads = [part.view_as(g) for part, g in zip(parts, grads)]
                total = parts[-1][0]
            out["loss"].append(float(total))
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
