"""K3's share of its roofline in training: the least time of the DCN
layers' backward at the traced shapes (``work/counts.py::dcn_bwd_bound``)
over the device time of the kernels named here, per step.
None where K3 did not run or the card's peaks are unknown."""
from benchmark.harness import trace
from benchmark.work import counts

UNIT = "%"
KERNELS = ("dcn_bwd_kernel", "dcn_bwd_gather")


def read(rec):
    pk = counts.peaks(rec["device_name"])
    ks = trace.matching(rec["dev"], KERNELS)
    if rec["kind"] != "train" or pk is None or not ks or not rec["dcn_layers"]:
        return None
    bound = sum(counts.dcn_bwd_bound(layer, pk) for layer in rec["dcn_layers"]) * rec["units"]
    return 100.0 * bound / (sum(e - s for _, s, e in ks) / 1e9)
