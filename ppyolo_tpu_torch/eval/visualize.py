"""Detection drawing (reference tools/visualize.py and decode_np.py:98-123).

Counterpart of ``ppyolo_tpu/eval/visualize.py``.
"""
from __future__ import annotations

import colorsys
import random
from typing import Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def get_colors(n: int, seed: int = 0):
    hsv = [(i / n, 1.0, 1.0) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    colors = [(int(r * 255), int(g * 255), int(b * 255)) for r, g, b in colors]
    rnd = random.Random(seed)
    rnd.shuffle(colors)
    return colors


def draw(image_bgr: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
         classes: np.ndarray, class_names: Sequence[str]) -> np.ndarray:
    """Draw boxes in place (reference decode_np.py:98-123 style)."""
    colors = get_colors(len(class_names))
    for box, score, cl in zip(boxes, scores, classes):
        x0, y0, x1, y1 = box
        left, top = int(x0), int(y0)
        right, bottom = int(x1), int(y1)
        color = colors[int(cl) % len(colors)]
        bbox_thick = 1 if min(image_bgr.shape[:2]) < 400 else 2
        cv2.rectangle(image_bgr, (left, top), (right, bottom), color, bbox_thick)
        text = f"{class_names[int(cl)]}: {score:.2f}"
        t_size = cv2.getTextSize(text, 0, 0.7, thickness=bbox_thick // 2)[0]
        cv2.rectangle(image_bgr, (left, top),
                      (left + t_size[0], top - t_size[1] - 3), color, -1)
        cv2.putText(image_bgr, text, (left, top - 2), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (0, 0, 0), bbox_thick // 2, lineType=cv2.LINE_AA)
    return image_bgr
