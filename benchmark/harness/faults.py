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


@contextlib.contextmanager
def no_exchange():
    """Sync-BN with the exchange between the ranks left out: every
    BatchNorm of the program is built without ``sync``, so each rank
    normalizes by its own batch's statistics (and sums its own gradients
    of them) while the gradients are still averaged over the ranks."""
    from ppyolo_tpu_torch.ops import module

    init = module.BatchNorm.__init__

    def local(self, channels, sync=False):
        init(self, channels, sync=False)

    module.BatchNorm.__init__ = local
    try:
        yield
    finally:
        module.BatchNorm.__init__ = init


@contextlib.contextmanager
def no_grad_exchange():
    """Data parallelism with the gradient all-reduce left out: the port's
    ``all_reduce_mean`` hands back its inputs, so each rank steps on the
    gradients (and reports the losses) of its own batch, while sync-BN
    still exchanges its statistics."""
    from ppyolo_tpu_torch.parallel import dist

    mean = dist.all_reduce_mean
    dist.all_reduce_mean = list
    try:
        yield
    finally:
        dist.all_reduce_mean = mean


# faults on the program's answers, applied to each call's output
SERVE = {"half_batch": lambda: half_batch, "altered_answer": AlteredAnswer}
# faults planted inside the program for the whole run
PROGRAM = {"no_nms_decay": no_nms_decay, "no_exchange": no_exchange,
           "no_grad_exchange": no_grad_exchange}
