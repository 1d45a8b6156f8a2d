"""COCO evaluation harness (reference tools/cocotools.py).

Counterpart of ``ppyolo_tpu/eval/coco_eval.py`` in one process: a reader
thread decodes and resizes the next batch while the card runs the current
one, each image's detections go to a shard ``result_dir/bbox/<id>.json``
(xywh with the reference's +1 pixel convention, category ids remapped,
coordinates rounded to 0.1), the merged list to
``result_dir/bbox_detections.json``, and the built-in COCOeval-compatible
``coco_metric.evaluate_map`` (or pycocotools, where it is installed) gives
the 12 stats.  ``type_='test_dev'`` writes the submission json only.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..data.coco import CocoJson, category_maps
from ..data.loader import Prefetcher

logger = logging.getLogger(__name__)

# COCO class-index <-> category-id maps (reference cocotools.py:22-36)
COCO_CLSID2CATID = {
    0: 1, 1: 2, 2: 3, 3: 4, 4: 5, 5: 6, 6: 7, 7: 8, 8: 9, 9: 10, 10: 11,
    11: 13, 12: 14, 13: 15, 14: 16, 15: 17, 16: 18, 17: 19, 18: 20, 19: 21,
    20: 22, 21: 23, 22: 24, 23: 25, 24: 27, 25: 28, 26: 31, 27: 32, 28: 33,
    29: 34, 30: 35, 31: 36, 32: 37, 33: 38, 34: 39, 35: 40, 36: 41, 37: 42,
    38: 43, 39: 44, 40: 46, 41: 47, 42: 48, 43: 49, 44: 50, 45: 51, 46: 52,
    47: 53, 48: 54, 49: 55, 50: 56, 51: 57, 52: 58, 53: 59, 54: 60, 55: 61,
    56: 62, 57: 63, 58: 64, 59: 65, 60: 67, 61: 70, 62: 72, 63: 73, 64: 74,
    65: 75, 66: 76, 67: 77, 68: 78, 69: 79, 70: 80, 71: 81, 72: 82, 73: 84,
    74: 85, 75: 86, 76: 87, 77: 88, 78: 89, 79: 90,
}
COCO_CATID2CLSID = {v: k for k, v in COCO_CLSID2CATID.items()}


def clsid_to_catid(cfg, coco: CocoJson) -> Dict[int, int]:
    """The COCO map for an 80-class model, else the annotation file's own
    (reference eval.py:75-94)."""
    return COCO_CLSID2CATID if cfg.num_classes == 80 else category_maps(coco)[1]


def get_classes(classes_path: str) -> List[str]:
    with open(classes_path) as f:
        return [c.strip() for c in f.readlines() if c.strip()]


def detections_to_coco(pred: np.ndarray, im_id: int,
                       clsid2catid: Dict[int, int]) -> List[dict]:
    """[keep_top_k, 6] rows -> COCO result dicts: xywh with the reference's
    +1 pixel convention, the category id remapped, coordinates rounded to
    the nearest 0.1 (cocotools.py:159-191)."""
    out = []
    for row in pred:
        label, score, x0, y0, x1, y1 = row
        if label < 0:
            continue
        w, h = x1 - x0 + 1, y1 - y0 + 1
        bbox = [round(float(v) * 10) / 10 for v in (x0, y0, w, h)]
        out.append({"image_id": int(im_id), "category_id": int(clsid2catid[int(label)]),
                    "bbox": bbox, "score": float(score)})
    return out


def evaluate_detections(detections: List[dict], anno_file: str, *, style: str = "bbox"):
    """Evaluate merged detections: pycocotools if installed, else built in."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        from .coco_metric import evaluate_map

        with open(anno_file) as f:
            gt = json.load(f)
        return evaluate_map(gt, detections)
    import tempfile

    coco_gt = COCO(anno_file)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(detections, f)
        tmp = f.name
    try:
        ev = COCOeval(coco_gt, coco_gt.loadRes(tmp), style)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
    finally:
        os.remove(tmp)
    return ev.stats


def coco_eval(detector, images: List[dict], eval_pre_path: str, anno_file: str,
              eval_batch_size: int, *, type_: str = "eval",
              result_dir: str = "eval_results",
              clsid2catid: Optional[Dict[int, int]] = None,
              draw_image: bool = False, draw_thresh: float = 0.15,
              class_names: Optional[List[str]] = None,
              distributed: bool = False, scan_group: int = 1):
    """Drive ``detector`` over ``images`` (COCO image records) in batches of
    ``eval_batch_size`` (the tail padded) and return the 12 box-AP stats,
    or None for ``type_ == 'test_dev'``.  With ``draw_image`` the
    detections above ``draw_thresh`` are drawn into ``result_dir/images``.

    ``scan_group > 1`` runs that many full batches as one unit of work
    (``Detector.predict_pipelined``: one graph replay on a card) and the
    remaining batches one by one; the detections and the shard files are
    the same as with ``scan_group=1``.  Multi-process evaluation
    (``distributed``) is not ported (ROADMAP §1 item 8)."""
    import cv2

    if distributed:
        raise NotImplementedError("distributed eval is not ported (ROADMAP §1 item 8)")
    clsid2catid = clsid2catid or COCO_CLSID2CATID
    bbox_dir = os.path.join(result_dir, "bbox")
    if os.path.exists(result_dir):
        shutil.rmtree(result_dir, ignore_errors=True)
    os.makedirs(bbox_dir, exist_ok=True)
    if draw_image:
        os.makedirs(os.path.join(result_dir, "images"), exist_ok=True)
    n = len(images)

    def read_batches():
        """imread + preprocess of the next batch, on the reader thread."""
        for i in range(0, n, eval_batch_size):
            batch = images[i:i + eval_batch_size]
            pimages, sizes, raw_imgs = [], [], []
            for im in batch:
                path = os.path.join(eval_pre_path, im["file_name"])
                img = cv2.imread(path)
                if img is None:
                    raise FileNotFoundError(f"cannot read image {path}")
                p, s = detector.process_image(img)
                pimages.append(p[0])
                sizes.append(s[0])
                raw_imgs.append(img if draw_image else None)
            pad = eval_batch_size - len(batch)   # a fixed batch shape
            pimages += [pimages[-1]] * pad
            sizes += [sizes[-1]] * pad
            yield np.stack(pimages), np.stack(sizes), batch, raw_imgs

    def write_one(dets, im, pred, raw_img):
        with open(os.path.join(bbox_dir, f"{im['id']}.json"), "w") as f:
            f.write(json.dumps(dets) + "\n")
        if draw_image:
            from .visualize import draw

            keep = (pred[:, 0] >= 0) & (pred[:, 1] >= draw_thresh)
            cn = class_names or [str(c) for c in range(1000)]
            draw(raw_img, pred[keep, 2:6], pred[keep, 1], pred[keep, 0].astype(np.int32), cn)
            cv2.imwrite(os.path.join(result_dir, "images", os.path.basename(im["file_name"])),
                        raw_img)

    all_dets: List[dict] = []
    start = time.time()
    with ThreadPoolExecutor(max_workers=4) as writers, \
            Prefetcher(read_batches(), max_batch=max(3, scan_group + 1)) as reader:
        pending = []

        def handle(preds, batch, raw_imgs):
            for j, im in enumerate(batch):
                dets = detections_to_coco(preds[j], im["id"], clsid2catid)
                all_dets.extend(dets)
                pending.append(writers.submit(write_one, dets, im, preds[j], raw_imgs[j]))

        def run_group(units):
            """A full group as one unit (``coco_eval.py:219-241``), a short
            tail batch by batch."""
            if scan_group > 1 and len(units) == scan_group:
                preds = detector.predict_pipelined(np.concatenate([u[0] for u in units]),
                                                   np.concatenate([u[1] for u in units]),
                                                   group=scan_group)
                for g, u in enumerate(units):
                    handle(preds[g * eval_batch_size:(g + 1) * eval_batch_size], u[2], u[3])
            else:
                for u in units:
                    handle(detector.predict_batch(u[0], u[1]), u[2], u[3])

        group: list = []
        for unit in reader:
            group.append(unit)
            if len(group) == max(scan_group, 1):
                run_group(group)
                group = []
        if group:
            run_group(group)
        for fut in pending:
            fut.result()   # a writer's exception surfaces here
    cost = time.time() - start
    logger.info("eval: %d images in %.2fs, %.1f img/s", n, cost, n / max(cost, 1e-9))
    merged = os.path.join(result_dir, "bbox_detections.json")
    with open(merged, "w") as f:
        json.dump(all_dets, f)
    if type_ == "test_dev":
        logger.info("test-dev submission written to %s", merged)
        return None
    return evaluate_detections(all_dets, anno_file)
