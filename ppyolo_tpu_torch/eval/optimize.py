"""Inference-time parameter rewrites: BN folding, precision casting and the
int8 serving mode.

Counterpart of ``ppyolo_tpu/eval/optimize.py`` (``fold_bn_params``,
``cast_params``, ``INT8_SKIP_PREFIXES``, ``quantize_params_int8``,
``calibrate_act_scales``, ``optimize_for_inference``) over a flat
``state_dict`` with OIHW conv weights.  The tree keeps its keys: folded BN
leaves become the identity transform (weight 1, bias b', mean 0, var
1-eps), so the same forward runs.  int8 rewrites ``<mod>.conv.weight`` to
int8 and adds ``<mod>.conv.weight_scale`` (and, calibrated,
``<mod>.conv.act_scale``); ``match_int8_form`` gives a model that form.
``int8_conv_shapes`` lists the shapes the int8 convs of a model see, and
``int8_conv_class`` the class each one's time is reported under.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..ops.conv import ConvNormAct, match_int8_form, recording
from ..ops.module import BN_EPS

StateDict = Dict[str, torch.Tensor]


def fold_bn_params(sd: StateDict, eps: float = BN_EPS) -> StateDict:
    """Fold every conv+BN pair: w' = w * scale/sqrt(var+eps) (over O),
    b' = bias - mean*scale/sqrt(var+eps).  Computed in fp64, stored in the
    leaves' own dtype."""
    out = dict(sd)
    for mod in sorted(k[: -len(".bn.weight")] for k in sd if k.endswith(".bn.weight")):
        wkey = (f"{mod}.conv.dcn_weight" if f"{mod}.conv.dcn_weight" in sd
                else f"{mod}.conv.weight")
        if wkey not in sd:
            continue
        scale = sd[f"{mod}.bn.weight"].double()
        bias = sd[f"{mod}.bn.bias"].double()
        mean = sd[f"{mod}.bn.running_mean"].double()
        var = sd[f"{mod}.bn.running_var"].double()
        k = scale / torch.sqrt(var + eps)
        dt = sd[f"{mod}.bn.weight"].dtype
        out[wkey] = (sd[wkey].double() * k.view(-1, 1, 1, 1)).to(sd[wkey].dtype)
        out[f"{mod}.bn.weight"] = torch.ones_like(scale, dtype=dt)
        out[f"{mod}.bn.bias"] = (bias - mean * k).to(dt)
        out[f"{mod}.bn.running_mean"] = torch.zeros_like(mean, dtype=dt)
        out[f"{mod}.bn.running_var"] = torch.full_like(var, 1.0 - eps, dtype=dt)
    return out


def cast_params(sd: StateDict, dtype: torch.dtype, keep_fp32_suffixes=()) -> StateDict:
    """Cast every fp32 leaf to ``dtype``, but those ending in one of
    ``keep_fp32_suffixes``."""
    return {k: v.to(dtype) if v.dtype == torch.float32 and not k.endswith(
        tuple(keep_fp32_suffixes)) else v for k, v in sd.items()}


# Never int8-quantized: the deep-stem convs (the fused stem kernel folds
# float weights) and, by the has-BN rule, the head's output convs and the
# DCN leaves (other key names).
INT8_SKIP_PREFIXES = ("backbone.stage1_conv1_",)


def quantize_params_int8(sd: StateDict, skip_prefixes=INT8_SKIP_PREFIXES,
                         act_scales: Optional[Dict[str, float]] = None,
                         min_k: int = 128) -> StateDict:
    """Per-output-channel symmetric int8 weights for every BN-carrying
    dense conv whose contraction k*k*cin is at least ``min_k``: ``s =
    max(amax|w|, 1e-12) / 127`` from the fp32 weight, ``clip(round(w / s),
    -127, 127)``, in numpy float32 exactly as the JAX package.  Call after
    ``fold_bn_params``.  ``act_scales`` (``calibrate_act_scales``) pins
    static activation scales as ``<mod>.conv.act_scale`` (0-d fp32)."""
    out = dict(sd)
    for wkey in [k for k in sd if k.endswith(".conv.weight")]:
        mod = wkey[: -len(".conv.weight")]
        if any(mod.startswith(p) for p in skip_prefixes) or f"{mod}.bn.weight" not in sd:
            continue
        w = sd[wkey].detach().cpu().float().numpy()   # OIHW
        if w.shape[1] * w.shape[2] * w.shape[3] < min_k:
            continue
        s = np.maximum(np.max(np.abs(w), axis=(1, 2, 3)), 1e-12) / 127.0
        q = np.clip(np.round(w / s[:, None, None, None]), -127, 127).astype(np.int8)
        out[wkey] = torch.from_numpy(q)
        out[f"{mod}.conv.weight_scale"] = torch.from_numpy(s.astype(np.float32))
        if act_scales and mod in act_scales:
            out[f"{mod}.conv.act_scale"] = torch.tensor(np.float32(act_scales[mod]))
    return out


@torch.no_grad()
def int8_conv_shapes(model: nn.Module, size: int, batch: int, probe: int = 32) -> list:
    """[(C, H, W, Co, k, stride, convs)] of the convs ``quantize_params_int8``
    quantizes in ``model`` (float weights, BN unfolded) served at size x
    size, batch ``batch``, sorted: each conv's input read by a hook in one
    forward of a probe x probe image on the model's device.  ``size`` must be
    a multiple of ``probe``, itself a multiple of the model's stride 32, so
    every map at ``size`` is size / probe times the probe's."""
    if size % probe or probe % 32:
        raise ValueError(f"size {size} is not a multiple of the probe {probe} (a multiple of 32)")
    q = quantize_params_int8(model.state_dict())
    mods = [m for n, m in model.named_modules()
            if isinstance(m, ConvNormAct) and f"{n}.conv.weight_scale" in q]
    found: Dict[tuple, int] = {}

    def hook(m, inp):
        _, c, h, w = inp[0].shape
        key = (c, h * size // probe, w * size // probe, m.cout, m.ksize, m.stride)
        found[key] = found.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in mods]
    p = next(model.parameters())
    try:
        model.outputs(torch.zeros(1, 3, probe, probe, dtype=p.dtype, device=p.device))
    finally:
        for h in hooks:
            h.remove()
    if sum(found.values()) != len(mods):
        raise AssertionError(f"{len(mods)} int8 convs, {sum(found.values())} ran")
    return [(*k, n) for k, n in sorted(found.items())]


def int8_conv_class(k: int, c: int, stride: int) -> str:
    """The class an int8 conv's time is reported under: 3x3 by stride, 1x1
    by whether C % 8 == 0 (the CoordConv inputs have C = 2 mod 8)."""
    if k == 3:
        return f"3x3 s{stride}"
    return "1x1 C%8=0" if c % 8 == 0 else "1x1 C=2 mod 8"


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, sd: Optional[StateDict], images: Iterable,
                         preprocess: Optional[Callable] = None) -> Dict[str, float]:
    """Static activation scales ``max(amax, 1e-6) / 127`` (float64 on the
    host, as the JAX package) from every non-DCN conv's input abs-max over
    ``images``, keyed by the conv's module path.  ``sd`` is loaded into
    ``model`` first (None: the model as it stands; the JAX package wants
    the BN-folded float params); ``images`` are normalized NCHW tensors in
    the model's dtype and device, or what ``preprocess`` makes them."""
    if sd is not None:
        match_int8_form(model, sd)
        model.load_state_dict(sd)
    names = {m: n for n, m in model.named_modules()}
    amax: Dict[str, float] = {}
    for x in images:
        if preprocess is not None:
            x = preprocess(x)
        with recording() as rec:
            model.outputs(x)
        for m, v in rec.items():
            amax[names[m]] = max(amax.get(names[m], 0.0), float(v))
    return {k: max(v, 1e-6) / 127.0 for k, v in amax.items()}


COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.bfloat16}


def optimize_for_inference(sd: StateDict, *, precision: str = "fp32",
                           fold_bn: bool = True) -> StateDict:
    """BN folded, then cast: bf16 everywhere, or int8 convs
    (``quantize_params_int8``) with bf16 everywhere else and the scales
    fp32."""
    if precision not in COMPUTE_DTYPES:
        raise NotImplementedError(f"precision '{precision}' is not supported")
    if fold_bn:
        sd = fold_bn_params(sd)
    if precision == "int8":
        sd = cast_params(quantize_params_int8(sd), torch.bfloat16,
                         keep_fp32_suffixes=(".weight_scale", ".act_scale"))
    elif precision == "bf16":
        sd = cast_params(sd, torch.bfloat16)
    return sd
