"""Batched, static-shape Matrix-NMS and multiclass (hard) NMS on the device.

Counterpart of ``ppyolo_tpu/ops/matrix_nms.py``.  ``matrix_nms``: the
two-stage exact top-k over a per-level virtual concat of the scores, the
decay matrix in fp32, and a fixed ``[B, keep_top_k, 6]`` output with -1
rows for empty slots.  ``multiclass_nms``: per-class greedy NMS over the
top ``nms_top_k`` (anchor, class) pairs, the same output.  Its greedy keep
is ``nms_keep``: the plain version (the [B, k, k] suppress matrix and the
JAX package's fixpoint iteration, eagerly) for a CPU tensor, the Hopper
kernel K6 (``csrc/nms_keep.cu``, which computes its own IoUs from the
candidates' boxes) for a CUDA tensor; ``nms_keep.launches`` counts K6's
launches.  ``multiclass_nms`` calls it as the ``ppyolo::nms_keep``
operator, so ``torch.export`` can hold it (``eval/export.py``).

``lax.top_k`` breaks ties by the lowest index; ``torch.topk`` promises no
order for ties (and bf16 scores tie often).  ``_topk`` therefore selects
with a stable descending sort and a slice, which gives the same total
order: value descending, then index ascending.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Sequence

import torch

from . import _build
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


def nms_keep_plain(valid: torch.Tensor, suppress: torch.Tensor) -> torch.Tensor:
    """The greedy keep as the JAX package computes it: from ``keep =
    valid``, ``keep = valid & ~any_j(keep[j] & suppress[j, i])`` until it
    stops changing (or k rounds).  valid [B, k] bool, suppress [B, k, k]
    bool (``[b, j, i]``: j suppresses i, only for j < i).  The suppression
    graph is a DAG, so the fixpoint is unique: the sequential greedy walk."""
    keep = valid
    for _ in range(valid.shape[1]):
        new = valid & ~(keep[:, :, None] & suppress).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def suppress_matrix(boxes: torch.Tensor, labels: torch.Tensor,
                    nms_threshold: float) -> torch.Tensor:
    """[B, k, k] bool, ``[b, j, i]``: candidate j comes before i, has its
    label and overlaps it by IoU > ``nms_threshold`` (the JAX package's
    ``suppress``)."""
    k = boxes.shape[1]
    iou = pairwise_iou(boxes, boxes, eps=1e-9)
    same = labels[:, :, None] == labels[:, None, :]
    earlier = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), 1)
    return (iou > nms_threshold) & same & earlier


def nms_keep_boxes_plain(valid: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
                         nms_threshold: float) -> torch.Tensor:
    """K6's plain version: the suppress matrix built eagerly, then the
    fixpoint ``nms_keep_plain``."""
    return nms_keep_plain(valid, suppress_matrix(boxes, labels, nms_threshold))


_KEEP_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float]
                  + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _keep_lib():
    lib = _build.load("nms_keep")
    lib.nms_keep_launch.argtypes = _KEEP_ARGTYPES
    lib.nms_keep_launch.restype = ctypes.c_int
    lib.nms_keep_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.nms_keep_scratch_bytes.restype = ctypes.c_longlong
    return lib


@_build.counted
def nms_keep(valid: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
             nms_threshold: float) -> torch.Tensor:
    """The greedy keep of k candidates in score order on valid's device:
    valid [B, k] bool, boxes [B, k, 4] xyxy, labels [B, k] int; a valid
    candidate is kept unless an earlier kept one of its label overlaps it
    by IoU > ``nms_threshold``.  ``nms_keep_boxes_plain`` for a CPU tensor;
    K6 for a CUDA tensor (fp32 boxes, int32 labels; it raises otherwise),
    which computes the IoUs it needs itself: no [B, k, k] tensor is made."""
    bsz, k = valid.shape
    if valid.dtype != torch.bool:
        raise ValueError(f"nms_keep: valid must be bool, got {valid.dtype}")
    if tuple(boxes.shape) != (bsz, k, 4) or tuple(labels.shape) != (bsz, k):
        raise ValueError(f"nms_keep: boxes {tuple(boxes.shape)} and labels "
                         f"{tuple(labels.shape)} are not ({bsz}, {k}, 4) and ({bsz}, {k})")
    if _build.recording():
        from ..utils.mfu import nms_keep_flops

        _build.note_call("nms_keep", nms_keep_flops(bsz, k), valid.is_cuda)
    if valid.device.type == "cpu":
        return nms_keep_boxes_plain(valid, boxes, labels, nms_threshold)
    if valid.device.type != "cuda" or {boxes.device, labels.device} != {valid.device}:
        raise ValueError(f"nms_keep: valid on {valid.device}, boxes on {boxes.device}, "
                         f"labels on {labels.device}")
    if boxes.dtype != torch.float32 or labels.dtype != torch.int32:
        raise ValueError(f"nms_keep kernel takes fp32 boxes and int32 labels, got "
                         f"{boxes.dtype} and {labels.dtype}")
    if k >= 2 ** 31 - 32:
        raise ValueError(f"nms_keep kernel indexes candidates in int32, got k = {k}")
    valid, boxes, labels = valid.contiguous(), boxes.contiguous(), labels.contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep: boxes must be 16-byte aligned")
    lib = _keep_lib()
    nbytes = lib.nms_keep_scratch_bytes(bsz, k)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=valid.device) if nbytes else None
    keep = torch.empty_like(valid)
    _build.note_launch(nms_keep)
    err = lib.nms_keep_launch(valid.data_ptr(), boxes.data_ptr(), labels.data_ptr(),
                              keep.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                              bsz, k, float(nms_threshold),
                              torch.cuda.current_stream(valid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError {err}")
    return keep


@torch.library.custom_op("ppyolo::nms_keep", mutates_args=())
def nms_keep_op(valid: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
                nms_threshold: float) -> torch.Tensor:
    """``nms_keep`` as an operator of the ``ppyolo`` library: its plain
    version's fixpoint loop ends on the data, which ``torch.export`` cannot
    trace, so a serving artifact holds this node (K6 on a card)."""
    return nms_keep(valid, boxes, labels, nms_threshold)


@nms_keep_op.register_fake
def _nms_keep_fake(valid, boxes, labels, nms_threshold):
    return torch.empty_like(valid)


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   nms_cfg: Dict[str, Any]) -> torch.Tensor:
    """Batched per-class greedy hard NMS (``matrix_nms.py:146-215``).

    boxes [B, A, 4] xyxy, scores [B, A, C].  The top ``nms_top_k`` (anchor,
    class) pairs above ``score_threshold`` in score order are the
    candidates; a candidate is dropped when an earlier kept one of its
    class overlaps it by IoU > ``nms_threshold``.  Returns [B, keep_top_k,
    6] rows (label, score, x0, y0, x1, y1), -1 rows for empty slots."""
    thr = float(nms_cfg.get("score_threshold", 0.01))
    nms_thr = float(nms_cfg.get("nms_threshold", 0.45))
    nms_top_k = int(nms_cfg.get("nms_top_k", 500))
    keep_top_k = int(nms_cfg.get("keep_top_k", 100))
    bsz, a, c = scores.shape
    k = min(nms_top_k, a * c)
    flat = scores.reshape(bsz, a * c)
    # masked-out sentinel sorts below every surviving score
    sent = 0.0 if thr >= 0.0 else float("-inf")
    vals, idx = _topk(torch.where(flat > thr, flat, sent), k)
    vals = vals.float()
    valid = vals > thr
    labels = idx % c
    cand = _take(boxes, idx // c)                                 # [B, k, 4]
    keep = torch.ops.ppyolo.nms_keep(valid, cand, labels.int(), nms_thr)
    # kept rows with non-positive scores (a negative threshold) stay valid
    final = torch.where(keep, vals, float("-inf"))
    out_vals, out_idx = _topk(final, min(keep_top_k, k))
    ok = torch.gather(keep, 1, out_idx)
    out_boxes = torch.where(ok[..., None], _take(cand, out_idx), -1.0)
    out_labels = torch.where(ok, torch.gather(labels, 1, out_idx).float(), -1.0)
    out_scores = torch.where(ok, out_vals, -1.0)
    return torch.cat([out_labels[..., None], out_scores[..., None], out_boxes], dim=-1)
