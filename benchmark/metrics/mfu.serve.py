"""The served model's share of the card's bf16 peak: the reference's
forward FLOPs per image (``work/counts.py``) times the images the traced
window served, over its seconds.  None on a card without a known peak."""
from benchmark.work import counts

UNIT = "%"


def read(rec):
    pk = counts.peaks(rec["device_name"])
    if rec["kind"] != "serve" or pk is None or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["flops_per_image"] * rec["images"] / rec["window_s"] / pk["bf16"]
