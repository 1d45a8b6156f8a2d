"""Batched, static-shape Matrix-NMS on the device.

Counterpart of ``ppyolo_tpu/ops/matrix_nms.py::matrix_nms``: the two-stage
exact top-k over a per-level virtual concat of the scores, the decay
matrix in fp32, and a fixed ``[B, keep_top_k, 6]`` output with -1 rows for
empty slots.

``lax.top_k`` breaks ties by the lowest index; ``torch.topk`` promises no
order for ties (and bf16 scores tie often).  ``_topk`` therefore selects
with a stable descending sort and a slice, which gives the same total
order: value descending, then index ascending.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from .iou import pairwise_iou


def _topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, descending,
    ties broken by the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [B, K] of x [B, A, D] -> [B, K, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _gather_levels(arrs: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the virtual concatenation (along dim 1) of per-level
    [B, A_l, D] tensors, without materializing the concat: per-level
    gathers of clamped rows, zeroed outside their level, summed."""
    out, off = None, 0
    for x in arrs:
        n = x.shape[1]
        local = idx - off
        g = _take(x, local.clamp(0, n - 1))
        g = torch.where(((local >= 0) & (local < n))[..., None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        out = g if out is None else out + g
        off += n
    return out


def matrix_nms(boxes, scores, nms_cfg: Dict[str, Any]) -> torch.Tensor:
    """Batched Matrix-NMS.

    boxes [B, A, 4] xyxy and scores [B, A, C], or matching lists of
    per-level [B, A_l, 4] / [B, A_l, C] (virtually concatenated along A).
    Returns [B, keep_top_k, 6] rows (label, score, x0, y0, x1, y1), -1 rows
    for empty slots.
    """
    if not isinstance(boxes, (list, tuple)):
        boxes, scores = (boxes,), (scores,)
    thr = float(nms_cfg["score_threshold"])
    post = float(nms_cfg["post_threshold"])
    nms_top_k = int(nms_cfg["nms_top_k"])
    keep_top_k = int(nms_cfg["keep_top_k"])
    use_gaussian = bool(nms_cfg.get("use_gaussian", False))
    sigma = float(nms_cfg.get("gaussian_sigma", 2.0))

    bsz = scores[0].shape[0]
    a = sum(s.shape[1] for s in scores)
    c = scores[0].shape[2]
    k = min(nms_top_k, a * c)
    kanch = min(max(512, k), a)
    # masked-out sentinel sorts below every surviving score
    sent = 0.0 if thr >= 0.0 else float("-inf")
    if c > 1 and a > 2 * kanch:
        # two-stage exact top-k: kanch anchors by max class score, then the
        # top-k pairs of their [kanch, c] scores (exactness argument in
        # ppyolo_tpu/ops/matrix_nms.py:87-92)
        anchor_max = torch.cat([torch.where(s > thr, s, sent).amax(dim=-1)
                                for s in scores], dim=1)          # [B, a]
        _, anchor_idx = _topk(anchor_max, kanch)                  # [B, kanch]
        sub_raw = _gather_levels(scores, anchor_idx)              # [B, kanch, c]
        sub = torch.where(sub_raw > thr, sub_raw, sent)
        vals, sub_i = _topk(sub.reshape(bsz, kanch * c), k)
        idx = torch.gather(anchor_idx, 1, sub_i // c) * c + sub_i % c
    else:
        flat = torch.cat(list(scores), dim=1).reshape(bsz, a * c)
        vals, idx = _topk(torch.where(flat > thr, flat, sent), k)
    # top-k runs in the score dtype; the k-sized decay epilogue is fp32
    vals = vals.float()
    valid = vals > thr
    labels = idx % c
    cand = _gather_levels(boxes, idx // c)                        # [B, k, 4]

    iou = pairwise_iou(cand, cand, eps=1e-9)                      # [B, k, k]
    tri = torch.triu(torch.ones((k, k), dtype=torch.bool, device=iou.device), 1)
    same = ((labels[:, :, None] == labels[:, None, :])
            & valid[:, :, None] & valid[:, None, :])
    decay_iou = torch.where(tri & same, iou, 0.0)
    comp = decay_iou.amax(dim=1)                                  # max over i < j
    comp_m = comp[:, :, None]                                     # [i][j] = comp[i]
    if use_gaussian:
        ratio = torch.exp(-sigma * (decay_iou ** 2 - comp_m ** 2))
    else:
        ratio = (1.0 - decay_iou) / (1.0 - comp_m)
    new_scores = vals * ratio.amin(dim=1)

    keep = (new_scores >= post) & valid
    final = torch.where(keep, new_scores, float("-inf"))
    out_vals, out_idx = _topk(final, min(keep_top_k, k))
    out_keep = torch.gather(keep, 1, out_idx)
    out_boxes = torch.where(out_keep[..., None], _take(cand, out_idx), -1.0)
    out_labels = torch.where(out_keep, torch.gather(labels, 1, out_idx).float(), -1.0)
    out_scores = torch.where(out_keep, out_vals, -1.0)
    return torch.cat([out_labels[..., None], out_scores[..., None], out_boxes], dim=-1)
