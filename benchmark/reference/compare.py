"""Judging served detections against the reference.

Each row the program returns, ``(label c, score s, box b)``, claims that
some anchor of the image sees class ``c`` at box ``b`` with at least score
``s`` (Matrix-NMS only lowers a score).  The reference decodes every
anchor of the same image in fp32; a row's claim error is

    min over anchors a of max(|b - B_a| / (w_a, h_a, w_a, h_a),
                              max(0, s - S_a[c]))

where B_a and S_a are the reference's box and class scores of anchor a,
a box side is taken no smaller than the anchor's grid stride, and a
coordinate the program clipped to the image's edge is left out: the
row's box read against the nearest reference box, relative to that box's
size, and the score it claims above what the reference gives the class
there.  A wrong label, an inflated score or a moved box shows; a swap of
near-tied rows does not, since every anchor is a candidate.

Each row is matched to the anchor of least claim error, and read there in
the network's output space, axis by axis: the centre's gap in grid cells
and the size's as |log| of the ratio, the largest of these (the "box
gap").  Only an axis whose two coordinates lie inside the image counts:
a coordinate clipped to the edge says nothing of the forward's
precision; rows clipped on both axes are left out.  A non-finite row,
and each row of either side's upper half that finds no pair on the other
side (below), counts as an infinite gap.

Readings over the sampled calls (limits in the cell's workload file):

- ``box_err_med``: the median box gap over all sampled rows, which
  follows the precision of the whole forward and is steady from seed to
  seed;
- ``image_err_max``: the largest, over the sampled images, of the image's
  median box gap: an image left out or emptied, or an answer that belongs
  to another image.

The rows themselves are then held to the reference's own Matrix-NMS
rows of the same image (its ``keep_top_k`` rows by decayed score).  Each
row of one side, best first, is paired with a row of the other side not
yet paired, of the same label, that overlaps it by IoU 0.3 or more (or
lies within a pixel of it).  So a swap of two near-tied, overlapping boxes
(of which Matrix-NMS decays the second out of the kept set) still pairs,
while duplicates of one box, which the decay would have pushed out, find
no pair of their own.  Only the upper half of each side (its
``keep_top_k / 2`` best rows) has to pair, so that rows crossing the cut
at ``keep_top_k`` do not count.

- ``nms_miss``: the share of those upper-half rows, of both sides and all
  sampled images, not found on the other side: a decay skipped or
  misapplied keeps duplicates in place of other boxes, and a row left
  out or added shows here;
- ``nms_score_gap_med``: over the rows found, the median gap between the
  program's decayed score and the reference's, over the reference's: a
  score scaled or not decayed.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .common import pairwise_iou, resize_bicubic

NMS_IOU = 0.3   # a row is found where a row of the same label overlaps it this much


def anchor_strides(cfg, net: int, device) -> torch.Tensor:
    """[A] the grid stride (network pixels) of every anchor, in decode order."""
    h = cfg["head"]
    return torch.cat([torch.full(((net // ds) ** 2 * len(m),), float(ds), device=device)
                      for m, ds in zip(h["anchor_masks"], h["downsample"])])


def claim_errors(rows: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
                 im_hw: torch.Tensor, strides: torch.Tensor, net: int):
    """rows [K, 6] valid program rows; boxes [A, 4], scores [A, C] of the
    reference for the same image; im_hw (h, w); strides [A] and the
    network's input size -> ([K] claim errors, [K] whether an axis lies
    inside the image, [K] box gaps at the matched anchors) (module
    docstring)."""
    if rows.shape[0] == 0:
        return rows.new_zeros(0), rows.new_zeros(0, dtype=torch.bool), rows.new_zeros(0)
    b = rows[:, 2:].float()
    h, w = float(im_hw[0]), float(im_hw[1])
    free = (b > 0) & (b < torch.tensor([w, h, w, h], device=b.device))            # [K, 4]
    # x errors over the anchor box's width, y over its height, or over the
    # grid stride (in image pixels) where the box is smaller: a small box's
    # centre moves with the grid, not with its size
    cell = strides[:, None] * torch.tensor([w / net, h / net], device=b.device)   # [A, 2]
    wh = torch.maximum(boxes[:, 2:] - boxes[:, :2], cell).clamp_min(1.0).repeat(1, 2)  # [A, 4]
    rel = ((b[:, None, :] - boxes[None]).abs() / wh[None] * free[:, None, :]).amax(-1)  # [K, A]
    lab = rows[:, 0].long().clamp(0, scores.shape[1] - 1)
    excess = (rows[:, 1:2].float() - scores[:, lab].t()).clamp_min(0)              # [K, A]
    err, best = torch.maximum(rel, excess).min(1)
    bad_label = (rows[:, 0] != rows[:, 0].round()) | (rows[:, 0] >= scores.shape[1])
    inf = torch.full_like(err, float("inf"))
    # the matched anchor's box in the network's output space, per axis (x, y):
    # centre in grid cells, size as the log of the ratio (|delta t_wh|)
    a = boxes[best]
    c_p, c_a = (b[:, :2] + b[:, 2:]) / 2, (a[:, :2] + a[:, 2:]) / 2
    s_p = (b[:, 2:] - b[:, :2]).clamp_min(1e-3)
    s_a = (a[:, 2:] - a[:, :2]).clamp_min(1e-3)
    t = torch.stack([(c_p - c_a).abs() / cell[best], (s_p / s_a).log().abs()], -1)  # [K, 2, 2]
    axis = free[:, :2] & free[:, 2:]                                               # [K, 2]
    gap = (t * axis[..., None]).amax((1, 2))
    return torch.where(bad_label, inf, err), axis.any(1), torch.where(bad_label, inf, gap)


def found(a: torch.Tensor, b: torch.Tensor, iou_min: float = NMS_IOU):
    """a [Ka, 6], b [Kb, 6] valid rows, each side by descending score ->
    ([Ka] whether each row of a is found in b, [Ka] the index in b of its
    pair): each row of a in turn takes the row of b, not yet taken, of the
    same label that overlaps it most, by IoU ``iou_min`` or more (or
    within a pixel)."""
    hit = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    pair = torch.zeros(a.shape[0], dtype=torch.long, device=a.device)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return hit, pair
    same = a[:, None, 0] == b[None, :, 0]
    iou = pairwise_iou(a[:, 2:], b[:, 2:]) * same
    near = ((a[:, None, 2:] - b[None, :, 2:]).abs().amax(-1) <= 1.0) & same
    iou = torch.where(near, torch.ones_like(iou), iou)
    taken = torch.zeros(b.shape[0], dtype=torch.bool, device=a.device)
    for i in range(a.shape[0]):
        v = iou[i].masked_fill(taken, -1.0)
        j = int(v.argmax())
        if float(v[j]) >= iou_min:
            hit[i], pair[i], taken[j] = True, j, True
    return hit, pair


def nms_rows(prog: torch.Tensor, refr: torch.Tensor, half: int):
    """Valid rows of one image's program and reference outputs -> (rows
    of the upper halves not found on the other side, rows counted, the
    relative score gaps of the rows found)."""
    prog = prog[torch.sort(prog[:, 1], descending=True, stable=True).indices]
    miss, n, gaps = 0, 0, []
    for a, b, a_is_prog in ((refr[:half], prog, False), (prog[:half], refr, True)):
        hit, j = found(a, b)
        miss += int((~hit).sum())
        n += a.shape[0]
        if not hit.any():
            continue
        s_p, s_r = (a[:, 1], b[j, 1]) if a_is_prog else (b[j, 1], a[:, 1])
        gaps.append(((s_p - s_r).abs() / s_r)[hit])
    return miss, n, torch.cat(gaps) if gaps else prog.new_zeros(0)


def judge(ref, cfg, P: Dict[str, torch.Tensor], calls: List[dict], device) -> Dict[str, float]:
    """Readings of the reference module ``ref`` (``reference/__init__.py``)
    over ``calls``: each {"images": [n,S,S,3] uint8 as served
    (or "frames": BGR uint8 arrays and "resize": S, resized here),
    "im_size": [n,2], "out": [n, keep_top_k, 6] the program's rows}."""
    rows_all, per_image, gaps = [], [], []
    miss = counted = 0
    half = cfg["nms_cfg"]["keep_top_k"] // 2
    with torch.no_grad(), ref.fp32_exact():
        for call in calls:
            if "frames" in call:
                imgs = torch.stack([resize_bicubic(torch.from_numpy(f).to(device),
                                                       call["resize"]) for f in call["frames"]])
            else:
                imgs = torch.from_numpy(call["images"]).to(device)
            sizes = torch.from_numpy(call["im_size"]).to(device).float()
            rows_ref, boxes, scores = ref.detect(cfg, P, imgs, sizes)
            strides = anchor_strides(cfg, imgs.shape[1], device)
            out = torch.from_numpy(call["out"]).to(device)
            for i in range(out.shape[0]):
                valid = out[i, :, 0] >= 0
                prog = out[i][valid]
                finite = torch.isfinite(prog).all(1)
                _, free, gap = claim_errors(prog[finite], boxes[i], scores[i], sizes[i],
                                              strides, imgs.shape[1])
                m, c, g = nms_rows(prog[finite], rows_ref[i][rows_ref[i, :, 0] >= 0], half)
                bad = int((~finite).sum())      # a non-finite row is a row not found
                img = torch.cat([gap[free], torch.full((m + bad,), float("inf"), device=device)])
                rows_all.append(img)
                per_image.append(float(img.median()) if img.numel() else 0.0)
                miss, counted = miss + m + bad, counted + c + bad
                gaps.append(g)
    rows = torch.cat(rows_all) if rows_all else torch.zeros(0)
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    return {"box_err_med": float(rows.median()) if rows.numel() else 0.0,
            "image_err_max": max(per_image) if per_image else 0.0,
            "nms_miss": miss / counted if counted else 0.0,
            "nms_score_gap_med": float(g.median()) if g.numel() else float("inf")}
