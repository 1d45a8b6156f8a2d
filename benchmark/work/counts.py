"""Work counts: model FLOPs from the plain reference, the hand-written
kernels' operation and byte counts, and the card's peaks.

``model_flops`` runs a configuration's reference module
(``reference/__init__.py``) on meta tensors under
``torch.utils.flop_counter.FlopCounterMode`` at a cell's shapes: the
matrix products and convolutions of the published
architecture (elementwise work counts nothing), the same for any
implementation of it.  With ``train`` it counts the forward and the
backward to every trainable leaf and the input-free activations.  The
DCN layers met on the way are recorded with their shapes, for the
kernels' bounds (where the module has ``deform_conv``).

``dcn_fwd_bound`` and ``dcn_bwd_bound`` are frozen copies of
``chip_smoke.py``'s K1 and K3 counts: K1 does 2 P k^2 C Co operations
(bf16 tensor cores) on x, the offsets and mask, its packed weight and
its output, each moved once in bf16; K3 does 27 fp32 operations per
(pixel, tap, channel) on the CUDA cores and moves x, om and dm (bf16) in
and dx (fp32), d_om and the columns (bf16) out.  A bound is the larger of
operations over the peak rate and bytes over the memory bandwidth.
"""
from __future__ import annotations

from typing import Dict, List, Optional

PEAKS = {   # NVIDIA H100 SXM5 datasheet, dense, at the 700 W limit
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def dcn_fwd_bound(layer: dict, pk: Dict[str, float]) -> float:
    """K1's least time in seconds for one DCN layer call."""
    n, c, h, w, co, oh, ow, k2 = (layer[k] for k in ("n", "c", "h", "w", "co", "oh", "ow", "k2"))
    flops = 2.0 * n * oh * ow * k2 * c * co
    nbytes = (n * c * h * w + n * 3 * k2 * oh * ow + k2 * c * co + n * oh * ow * co) * 2
    return max(flops / pk["bf16"], nbytes / pk["bytes"])


def dcn_bwd_bound(layer: dict, pk: Dict[str, float]) -> float:
    """K3's least time in seconds for one DCN layer's backward."""
    n, c, h, w, oh, ow, k2 = (layer[k] for k in ("n", "c", "h", "w", "oh", "ow", "k2"))
    ops = 27.0 * n * oh * ow * k2 * c
    x, om, elems = n * c * h * w, n * 3 * k2 * oh * ow, n * oh * ow * k2 * c
    nbytes = (x + om + elems) * 2 + x * 4 + (om + elems) * 2
    return max(ops / pk["fp32"], nbytes / pk["bytes"])


def model_flops(ref, cfg, size: int, batch: int = 1, train: bool = False) -> dict:
    """{"flops": per batch, "dcn_layers": [shape dicts]} of the reference
    module ``ref`` at ``batch`` x ``size`` x ``size`` (forward, or forward
    + backward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device("meta")
    P = {k: torch.zeros(s, device=dev) for k, s in ref.param_shapes(cfg).items()}
    trainable = [v for k, v in P.items() if not k.endswith(("running_mean", "running_var"))]
    layers: List[dict] = []
    deform = getattr(ref, "deform_conv", None)

    def recording(x, weight, om, stride, pad):
        n, c, h, w = x.shape
        layers.append(dict(n=n, c=c, h=h, w=w, co=weight.shape[0], oh=om.shape[2],
                           ow=om.shape[3], k2=weight.shape[2] * weight.shape[3]))
        return deform(x, weight, om, stride, pad)

    if deform is not None:
        ref.deform_conv = recording
    try:
        with FlopCounterMode(display=False) as fc:
            if train:
                for v in trainable:
                    v.requires_grad_(True)
                drop = lambda shape: torch.zeros(shape, device=dev)
                net = ref.Net(cfg, P, mode="train", drop_uniform=drop)
                outs = net(torch.zeros(batch, 3, size, size, device=dev))
                sum(o.float().sum() for o in outs).backward()
            else:
                with torch.no_grad():
                    ref.Net(cfg, P)(torch.zeros(batch, 3, size, size, device=dev))
    finally:
        if deform is not None:
            ref.deform_conv = deform
    return {"flops": float(fc.get_total_flops()), "dcn_layers": layers}
