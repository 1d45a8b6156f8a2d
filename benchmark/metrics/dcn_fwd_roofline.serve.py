"""K1's share of its roofline in serving: the least time of the DCN
layers at the traced shapes (``work/counts.py::dcn_fwd_bound``) over the
device time of the kernels named here, per image.  None where K1 did not
run (a model without DCN) or the card's peaks are unknown."""
from benchmark.harness import trace
from benchmark.work import counts

UNIT = "%"
KERNELS = ("dcn_fwd_kernel",)


def read(rec):
    pk = counts.peaks(rec["device_name"])
    ks = trace.matching(rec["dev"], KERNELS)
    if rec["kind"] != "serve" or pk is None or not ks or not rec["dcn_layers"]:
        return None
    bound = sum(counts.dcn_fwd_bound(layer, pk) for layer in rec["dcn_layers"]) * rec["units"]
    return 100.0 * bound / (sum(e - s for _, s, e in ks) / 1e9)
