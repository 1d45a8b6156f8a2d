"""Deformable position-sensitive ROI pooling, plain PyTorch.

Counterpart of ``ppyolo_tpu/ops/deform_psroi_pool.py`` (itself the
reference's vendored CUDA op, external/DCNv2/src/cuda/
dcn_v2_psroi_pooling_cuda.cu:59-148).  PP-YOLO never calls it; R-FCN-style
heads do.  The JAX function is plain jnp, not a Pallas kernel, so this is
plain torch too, and its gradients come from autograd as JAX's come from
autodiff.

Semantics as JAX's: rounded ROI corners scaled by ``spatial_scale`` with
the -0.5 shift, extents clamped at 0.1, per-part offsets times
``trans_std`` (scaled by the ROI's extent), ``sample_per_part**2``
bilinear samples a bin averaged over the in-bounds ones, and
position-sensitive channels ``(ctop * G + gh) * G + gw``.  JAX maps one ROI
at a time (``vmap``); here every ROI, bin and output channel is one
element of [R, p, p, D] index tensors, and the samples are gathers from
the flattened input.  Layouts follow the port: ``x`` NCHW (any memory
format), the output [R, output_dim, p, p]; ``trans`` keeps the JAX layout
[R, part, part, 2 * num_classes] (x, y offsets per class).  The arithmetic
is fp32 for fp32 and bf16 input (JAX's ``astype(float32)``), fp64 for fp64.
"""
from __future__ import annotations

from typing import Optional

import torch

from .deform_conv import _clip   # jnp.clip, with its half gradient on a bound


def deform_psroi_pool(x: torch.Tensor, rois: torch.Tensor, trans: Optional[torch.Tensor], *,
                      spatial_scale: float, output_dim: int, group_size: int,
                      pooled_size: int, part_size: Optional[int] = None,
                      sample_per_part: int = 4, trans_std: float = 0.0) -> torch.Tensor:
    """x [N, C, H, W] with C = output_dim * group_size**2, rois [R, 5]
    (batch index, x1, y1, x2, y2), trans [R, part, part, 2K] or None ->
    pooled [R, output_dim, pooled_size, pooled_size]."""
    n, channels, height, width = x.shape
    part_size = part_size or pooled_size
    num_classes = 1 if trans is None else trans.shape[-1] // 2
    per_class = output_dim // num_classes
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    p, g = pooled_size, group_size

    r = rois.to(acc)
    batch_ind = r[:, 0].long()
    start_w = torch.round(r[:, 1]) * spatial_scale - 0.5
    start_h = torch.round(r[:, 2]) * spatial_scale - 0.5
    end_w = (torch.round(r[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(r[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(end_w - start_w, 0.1)
    roi_h = torch.clamp_min(end_h - start_h, 0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    sub_w, sub_h = bin_w / sample_per_part, bin_h / sample_per_part

    pos = torch.arange(p, dtype=acc, device=dev)
    part = torch.floor(pos / p * part_size).long()
    ctop = torch.arange(output_dim, device=dev)
    class_id = ctop // per_class

    def per_roi(v):   # [R] -> [R, 1, 1, 1]
        return v.view(-1, 1, 1, 1)

    if trans is None:
        tx = ty = torch.zeros((), dtype=acc, device=dev)
    else:
        txy = trans.to(acc)[:, part[:, None], part[None, :], :]          # [R, p, p, 2K]
        tx = txy[..., 2 * class_id] * trans_std                           # [R, p, p, D]
        ty = txy[..., 2 * class_id + 1] * trans_std
    wstart = pos.view(1, 1, p, 1) * per_roi(bin_w) + per_roi(start_w) + tx * per_roi(roi_w)
    hstart = pos.view(1, p, 1, 1) * per_roi(bin_h) + per_roi(start_h) + ty * per_roi(roi_h)

    grp = torch.clamp(torch.floor(pos * g / p), 0, g - 1).long()
    chan = (ctop.view(1, 1, -1) * g + grp.view(-1, 1, 1)) * g + grp.view(1, -1, 1)  # [p, p, D]
    # flat offset of (roi's image, channel) in the contiguous NCHW input
    base = ((batch_ind.view(-1, 1, 1, 1) * channels + chan) * height) * width        # [R, p, p, D]
    xf = x.to(acc).contiguous().view(-1)

    def sample(w: torch.Tensor, h: torch.Tensor):
        inb = (w >= -0.5) & (w <= width - 0.5) & (h >= -0.5) & (h <= height - 0.5)
        w = _clip(w, 0.0, width - 1.0)
        h = _clip(h, 0.0, height - 1.0)
        w0, h0 = torch.floor(w), torch.floor(h)
        w1 = torch.clamp_max(w0 + 1, width - 1.0)
        h1 = torch.clamp_max(h0 + 1, height - 1.0)
        lw, lh = w - w0, h - h0

        def at(hi, wi):
            return xf[base + hi.long() * width + wi.long()]

        v = ((1 - lh) * (1 - lw) * at(h0, w0) + (1 - lh) * lw * at(h0, w1)
             + lh * (1 - lw) * at(h1, w0) + lh * lw * at(h1, w1))
        return torch.where(inb, v, torch.zeros_like(v)), inb.to(acc)

    total = cnt = None
    for ih in range(sample_per_part):
        for iw in range(sample_per_part):
            v, c = sample(wstart + iw * per_roi(sub_w), hstart + ih * per_roi(sub_h))
            total = v if total is None else total + v
            cnt = c if cnt is None else cnt + c
    out = torch.where(cnt > 0, total / torch.clamp_min(cnt, 1.0), torch.zeros_like(total))
    return out.permute(0, 3, 1, 2)
