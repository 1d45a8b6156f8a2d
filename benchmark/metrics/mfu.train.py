"""The training step's share of the card's bf16 peak: the reference's
forward and backward FLOPs per image (``work/counts.py``) times the
images stepped in the traced window, over its seconds and the peak.
None on a card without a known peak."""
from benchmark.work import counts

UNIT = "%"


def read(rec):
    pk = counts.peaks(rec["device_name"])
    if rec["kind"] != "train" or pk is None or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["flops_per_image"] * rec["images"] / rec["window_s"] / pk["bf16"]
