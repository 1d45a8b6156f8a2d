"""Self-contained COCO detection mAP (COCOeval-compatible, bbox style).

Counterpart of ``ppyolo_tpu/eval/coco_metric.py``, the same arithmetic in
the same order: IoU thresholds 0.50:0.05:0.95, 101-point recall
interpolation, the area ranges, maxDets 1/10/100, crowd-IoU semantics,
per-category averaging over the categories present in the gt, ids
evaluated sorted-unique and gt ``ignore`` honoured.  ``evaluate_map``
returns the 12 standard stats (stats[0] = mAP@[.5:.95]).  The pairwise
IoU and the greedy matching run in the native host library when it is
built, else in the numpy/Python loops beside them.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from .. import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """Pairwise IoU of xywh boxes; crowd gt uses union = dt area."""
    ious = np.zeros((len(dt), len(gt)), np.float64)
    for j, g in enumerate(gt):
        gx1, gy1, gw, gh = g
        gx2, gy2 = gx1 + gw, gy1 + gh
        ga = gw * gh
        for i, d in enumerate(dt):
            dx1, dy1, dw, dh = d
            dx2, dy2 = dx1 + dw, dy1 + dh
            da = dw * dh
            iw = min(dx2, gx2) - max(dx1, gx1)
            ih = min(dy2, gy2) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = da if iscrowd[j] else da + ga - inter
            ious[i, j] = inter / union
    return ious


def _match_img(dts, gts, ious_full, area_rng):
    """Match one (image, category) given precomputed IoUs in original gt
    order; dts already score-sorted and truncated to the largest maxDet."""
    g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)
    # pycocotools _prepare: ann['ignore'] = iscrowd or explicit ignore flag;
    # evaluateImg then ORs in the area-range test.  Only CROWD drives the
    # multi-match rule below; a plain ignore=1 gt is ignored but single-match.
    g_ignore = (g_crowd
                | np.array([bool(g.get("ignore", 0)) for g in gts], bool)
                | np.array([g["area"] < area_rng[0] or g["area"] > area_rng[1]
                            for g in gts], bool))
    # gt order: non-ignored first (pycocotools sorts by ignore flag)
    g_order = np.argsort(g_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    g_ignore = g_ignore[g_order]
    g_crowd = g_crowd[g_order]
    ious = (ious_full[:, g_order] if ious_full.size
            else np.zeros((len(dts), len(gts))))

    T = len(IOU_THRS)
    nm = (native.match_greedy(ious, g_ignore, g_crowd, IOU_THRS)
          if ious.size else None)
    if nm is not None:
        dt_m, gt_m = nm
    else:
        dt_m = np.zeros((T, len(dts)), np.int64) - 1
        gt_m = np.zeros((T, len(gts)), np.int64) - 1
        for t, thr in enumerate(IOU_THRS):
            for di in range(len(dts)):
                best, m = min(thr, 1 - 1e-10), -1
                for gi in range(len(gts)):
                    # only CROWD gts may be matched by multiple dts
                    # (pycocotools: `if gtm>0 and not iscrowd: continue`);
                    # an area-ignored non-crowd gt is taken by its first
                    # match like any regular gt
                    if gt_m[t, gi] >= 0 and not g_crowd[gi]:
                        continue
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break     # into ignored gts: keep current match
                    if ious[di, gi] < best:
                        continue
                    best, m = ious[di, gi], gi
                if m >= 0:
                    dt_m[t, di] = m
                    gt_m[t, m] = di
    a = np.array([d["area"] for d in dts], np.float64)
    dt_out_rng = (a < area_rng[0]) | (a > area_rng[1])
    dt_ignore = np.zeros((T, len(dts)), bool)
    for t in range(T):
        for di in range(len(dts)):
            m = dt_m[t, di]
            dt_ignore[t, di] = (g_ignore[m] if m >= 0 else dt_out_rng[di])
    return {
        "dt_scores": np.array([d["score"] for d in dts], np.float64),
        "dt_matched": dt_m >= 0,
        "dt_ignore": dt_ignore,
        "num_gt": int((~g_ignore).sum()),
    }


def evaluate_map(gt_annotations: Dict, detections: List[Dict],
                 *, verbose: bool = True) -> np.ndarray:
    """COCO bbox evaluation.

    gt_annotations: COCO-format dict (images/annotations/categories).
    detections: list of {image_id, category_id, bbox [x,y,w,h], score}.
    Returns the 12 COCO stats (AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l).
    """
    # pycocotools evaluates sorted-unique ids (COCOeval.__init__ sorts,
    # evaluate() np.unique's); iteration order matters for cross-image
    # score ties under the stable mergesort, so match it exactly.
    img_ids = sorted({im["id"] for im in gt_annotations["images"]})
    cat_ids = sorted({c["id"] for c in gt_annotations["categories"]})
    gt_by = defaultdict(list)
    for g in gt_annotations["annotations"]:
        g = dict(g)
        if "area" not in g:
            g["area"] = g["bbox"][2] * g["bbox"][3]
        gt_by[(g["image_id"], g["category_id"])].append(g)
    dt_by = defaultdict(list)
    for d in detections:
        d = dict(d)
        d["area"] = d["bbox"][2] * d["bbox"][3]
        dt_by[(d["image_id"], d["category_id"])].append(d)

    T, R = len(IOU_THRS), len(REC_THRS)
    area_names = list(AREA_RNGS)
    max_dets = [1, 10, 100]
    K, A, M = len(cat_ids), len(area_names), len(max_dets)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))

    for k, cat in enumerate(cat_ids):
        # IoUs once per (img, cat); matches once per (img, cat, area) at the
        # largest maxDet — smaller maxDets are exact per-image truncations
        # (greedy matching of dt i never depends on later dts), the same
        # factorization pycocotools uses.  This is what makes full val2017
        # (5k imgs x 80 cats) tractable in pure python + the native matcher.
        per_area_evals = {a: [] for a in range(len(area_names))}
        md_max = max(max_dets)
        for i in img_ids:
            dts = dt_by.get((i, cat), [])
            gts = gt_by.get((i, cat), [])
            if not dts and not gts:
                continue
            d_order = np.argsort([-d["score"] for d in dts],
                                 kind="stable")[:md_max]
            dts = [dts[j] for j in d_order]
            if dts and gts:
                dtb = np.array([d["bbox"] for d in dts], np.float64)
                gtb = np.array([g["bbox"] for g in gts], np.float64)
                crowd = np.array([g.get("iscrowd", 0) for g in gts], bool)
                ious_full = native.bbox_iou_xywh(dtb, gtb, crowd)
                if ious_full is None:
                    ious_full = _bbox_iou_xywh(dtb, gtb, crowd)
            else:
                ious_full = np.zeros((len(dts), len(gts)))
            for a, aname in enumerate(area_names):
                rng = AREA_RNGS[aname]
                per_area_evals[a].append(_match_img(dts, gts, ious_full, rng))

        for a in range(len(area_names)):
            evals = per_area_evals[a]
            if not evals:
                continue
            for m, md in enumerate(max_dets):
                scores = np.concatenate([e["dt_scores"][:md] for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate(
                    [e["dt_matched"][:, :md] for e in evals], 1)[:, order]
                ignored = np.concatenate(
                    [e["dt_ignore"][:, :md] for e in evals], 1)[:, order]
                num_gt = sum(e["num_gt"] for e in evals)
                if num_gt == 0:
                    continue
                tps = np.logical_and(matched, ~ignored)
                fps = np.logical_and(~matched, ~ignored)
                tp_sum = np.cumsum(tps, 1).astype(np.float64)
                fp_sum = np.cumsum(fps, 1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    rc = tp / num_gt
                    pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                    recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                    q = np.zeros(R)
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, k, a, m] = q

    def _summ(ap, iou=None, area="all", md=100):
        aind = area_names.index(area)
        mind = max_dets.index(md)
        if ap:
            s = precision[:, :, :, aind, mind]
            if iou is not None:
                s = s[[np.where(np.isclose(IOU_THRS, iou))[0][0]]]
        else:
            s = recall[:, :, aind, mind]
            if iou is not None:
                s = s[[np.where(np.isclose(IOU_THRS, iou))[0][0]]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = np.array([
        _summ(1), _summ(1, 0.5), _summ(1, 0.75),
        _summ(1, area="small"), _summ(1, area="medium"), _summ(1, area="large"),
        _summ(0, md=1), _summ(0, md=10), _summ(0, md=100),
        _summ(0, area="small"), _summ(0, area="medium"), _summ(0, area="large"),
    ])
    if verbose:
        labels = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                  "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]
        print(" ".join(f"{l}={v:.3f}" for l, v in zip(labels, stats)))
    return stats
