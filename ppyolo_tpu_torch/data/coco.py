"""COCO-json dataset reading without pycocotools.

Counterpart of ``ppyolo_tpu/data/coco.py``: annotation loading, the
record-cleaning rules (bbox clip and validity filter), category id <->
class index maps, and the batch sampler that attaches mixup/cutmix
partners, with the same draws in the same order.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class CocoJson:
    """Minimal pycocotools.COCO equivalent over an annotation json."""

    def __init__(self, annotation_file: str):
        with open(annotation_file, "r") as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in d.get("annotations", []):
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_imgs(self, ids):
        return [self.imgs[i] for i in ids]

    def load_anns_of(self, img_id: int, iscrowd: Optional[bool] = None):
        anns = self.img_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]


def category_maps(coco: CocoJson):
    """catid<->clsid maps + class-name list (reference eval.py:75-94)."""
    cat_ids = coco.get_cat_ids()
    catid2clsid = {cid: i for i, cid in enumerate(cat_ids)}
    clsid2catid = {i: cid for cid, i in catid2clsid.items()}
    names = [coco.cats[cid]["name"] for cid in cat_ids]
    return catid2clsid, clsid2catid, names


def data_clean(coco: CocoJson, img_ids: Sequence[int],
               catid2clsid: Dict[int, int], image_dir: str,
               *, require_gt: bool = False) -> List[dict]:
    """Records with clipped/validated boxes (reference data_process.py:19-86)."""
    records = []
    for img_id in img_ids:
        img_anno = coco.imgs[img_id]
        im_fname = img_anno["file_name"]
        im_w = float(img_anno["width"])
        im_h = float(img_anno["height"])
        instances = coco.load_anns_of(img_id, iscrowd=False)
        bboxes = []
        anno_id = []
        for inst in instances:
            x, y, box_w, box_h = inst["bbox"]
            x1 = max(0, x)
            y1 = max(0, y)
            x2 = min(im_w - 1, x1 + max(0, box_w - 1))
            y2 = min(im_h - 1, y1 + max(0, box_h - 1))
            if inst.get("area", box_w * box_h) > 0 and x2 >= x1 and y2 >= y1:
                inst = dict(inst, clean_bbox=[x1, y1, x2, y2])
                bboxes.append(inst)
                anno_id.append(inst["id"])
        if require_gt and not bboxes:
            continue
        n = len(bboxes)
        gt_bbox = np.zeros((n, 4), np.float32)
        gt_class = np.zeros((n, 1), np.int32)
        gt_score = np.ones((n, 1), np.float32)
        is_crowd = np.zeros((n, 1), np.int32)
        for i, box in enumerate(bboxes):
            gt_class[i][0] = catid2clsid[box["category_id"]]
            gt_bbox[i, :] = box["clean_bbox"]
            is_crowd[i][0] = box.get("iscrowd", 0)
        records.append({
            "im_file": os.path.join(image_dir, im_fname) if image_dir else im_fname,
            "im_id": np.array([img_id]),
            "h": im_h,
            "w": im_w,
            "is_crowd": is_crowd,
            "gt_class": gt_class,
            "anno_id": anno_id,
            "gt_bbox": gt_bbox,
            "gt_score": gt_score,
        })
    return records


def get_samples(train_records, train_indexes, step, batch_size, iter_id,
                with_mixup, with_cutmix, mixup_steps, cutmix_steps,
                rng: np.random.RandomState):
    """Batch slice + random mixup/cutmix partner (data_process.py:88-113)."""
    indexes = train_indexes[step * batch_size:(step + 1) * batch_size]
    samples = []
    num = len(train_indexes)
    for i in range(len(indexes)):
        sample = copy.deepcopy(train_records[indexes[i]])
        sample["curr_iter"] = iter_id
        if with_mixup and iter_id <= mixup_steps:
            mix_idx = rng.randint(1, num)
            mix_idx = train_indexes[(mix_idx + step * batch_size + i) % num]
            sample["mixup"] = copy.deepcopy(train_records[mix_idx])
            sample["mixup"]["curr_iter"] = iter_id
        if with_cutmix and iter_id <= cutmix_steps:
            mix_idx = rng.randint(1, num)
            sample["cutmix"] = copy.deepcopy(train_records[mix_idx])
            sample["cutmix"]["curr_iter"] = iter_id
        samples.append(sample)
    return samples
