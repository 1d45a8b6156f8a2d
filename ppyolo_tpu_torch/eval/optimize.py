"""Inference-time parameter rewrites: BN folding and precision casting.

Counterpart of ``ppyolo_tpu/eval/optimize.py`` (``fold_bn_params``,
``cast_params``, ``optimize_for_inference``) over a flat ``state_dict``
with OIHW conv weights.  The tree keeps its keys: folded BN leaves become
the identity transform (weight 1, bias b', mean 0, var 1-eps), so the same
forward runs.  int8 is a later slice.
"""
from __future__ import annotations

from typing import Dict

import torch

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


def cast_params(sd: StateDict, dtype: torch.dtype) -> StateDict:
    """Cast every fp32 leaf to ``dtype``."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in sd.items()}


COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def optimize_for_inference(sd: StateDict, *, precision: str = "fp32",
                           fold_bn: bool = True) -> StateDict:
    if precision not in COMPUTE_DTYPES:
        raise NotImplementedError(f"precision '{precision}' is not ported yet")
    if fold_bn:
        sd = fold_bn_params(sd)
    if precision == "bf16":
        sd = cast_params(sd, torch.bfloat16)
    return sd
