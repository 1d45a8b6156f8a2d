"""Share of the traced training window in which no kernel, copy or memset
runs on the card: the union of the device records, so overlapping
records count once."""
from benchmark.harness import trace

UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(rec["dev"]) / 1e9 / rec["window_s"])
