"""Faults planted under the timed path, to show that the output check
fails them (``tools/control.py --fault``, ``tests/``).  Never used by a
benchmark run."""
from __future__ import annotations

import contextlib

import numpy as np


def half_batch(out: np.ndarray, i: int) -> np.ndarray:
    """Half of the batch left out: the second half's rows empty (-1), or at
    batch 1 every other call's."""
    out = out.copy()
    n = out.shape[0]
    if n > 1:
        out[n // 2:] = -1.0
    elif i % 2:
        out[:] = -1.0
    return out


class AlteredAnswer:
    """One answer altered where it is produced: the first image of each
    batch gets the last one's detections; at batch 1 every other call
    returns the call before's."""

    def __init__(self):
        self.last = None

    def __call__(self, out: np.ndarray, i: int) -> np.ndarray:
        prev, self.last = self.last, out
        out = out.copy()
        if out.shape[0] > 1:
            out[0] = out[-1]
        elif i % 2 and prev is not None:
            out[:] = prev
        return out


@contextlib.contextmanager
def no_nms_decay():
    """The program's Matrix-NMS with its decay left out: every pair of
    candidates reads IoU 0, so each keeps its raw score and the
    ``keep_top_k`` best raw candidates come out, duplicates included."""
    from ppyolo_tpu_torch.ops import matrix_nms

    iou = matrix_nms.pairwise_iou
    matrix_nms.pairwise_iou = lambda a, b, **kw: iou(a, b, **kw) * 0.0
    try:
        yield
    finally:
        matrix_nms.pairwise_iou = iou


# faults on the program's answers, applied to each call's output
SERVE = {"half_batch": lambda: half_batch, "altered_answer": AlteredAnswer}
# faults planted inside the program for the whole run
PROGRAM = {"no_nms_decay": no_nms_decay}
