"""The one generator of the benchmark's inputs: everything a run feeds the
program comes from a traffic file's parameters and ``--seed``.

Every seed gets the same amount of work: the same pool sizes, and where
the work depends on a size (a frame's resize), the same multiset of
sizes in another order.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def serve_batches(t: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """``pool`` preprocessed batches: uint8 [batch, size, size, 3] and each
    image's original (h, w) drawn from ``im_sizes``."""
    r = rng(seed, 1)
    sizes = np.asarray(t["im_sizes"], np.float32)
    out = []
    for _ in range(t["pool"]):
        out.append({"images": r.integers(0, 256, (t["batch"], t["size"], t["size"], 3),
                                         dtype=np.uint8),
                    "im_size": sizes[r.integers(0, len(sizes), t["batch"])]})
    return out


def frames(t: dict, seed: int) -> List[np.ndarray]:
    """``pool`` BGR uint8 frames, sizes cycling through ``im_sizes`` (h, w)
    in a seeded order."""
    r = rng(seed, 2)
    hw = [t["im_sizes"][i % len(t["im_sizes"])] for i in range(t["pool"])]
    order = r.permutation(len(hw))
    return [r.integers(0, 256, (int(hw[i][0]), int(hw[i][1]), 3), dtype=np.uint8)
            for i in order]


def train_batches(t: dict, cfg: dict, seed: int, rank: int = 0) -> List[Dict[str, np.ndarray]]:
    """``pool`` host batches of a training job (``chip_smoke.py``'s
    ``synthetic_train_batch``): uint8 images, ``boxes`` ground-truth boxes
    (normalized xywh, centres in [0.2, 0.8], sizes in [0.05, 0.4]) in the
    first of ``max_boxes`` padded slots, random classes, score 1.  Each
    rank draws its own.

    With ``exposure`` [lo, hi] each image's contrast is scaled by a gain
    drawn from [lo, hi] and lifted by a drawn share of the room left, as
    photos differ in exposure: without it every image, and so every rank's
    batch, has the same statistics to a part in 10^4, and BN statistics
    taken over one rank's images could not be told from the whole group's."""
    r = rng(seed, 100 + rank)
    b, s, m, k = t["batch"], t["size"], t["max_boxes"], t["boxes"]
    out = []
    for _ in range(t["pool"]):
        gt_bbox = np.zeros((b, m, 4), np.float32)
        gt_bbox[:, :k, 0:2] = r.uniform(0.2, 0.8, (b, k, 2))
        gt_bbox[:, :k, 2:4] = r.uniform(0.05, 0.4, (b, k, 2))
        gt_score = np.zeros((b, m), np.float32)
        gt_score[:, :k] = 1.0
        batch = {"image": r.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
                 "gt_bbox": gt_bbox,
                 "gt_class": r.integers(0, cfg["num_classes"], (b, m)).astype(np.int32),
                 "gt_score": gt_score}
        if "exposure" in t:
            gain = r.uniform(*t["exposure"], (b, 1, 1, 1))
            lift = r.uniform(0.0, 1.0, (b, 1, 1, 1)) * 255.0 * (1.0 - gain)
            batch["image"] = np.rint(batch["image"] * gain + lift).astype(np.uint8)
        out.append(batch)
    return out
