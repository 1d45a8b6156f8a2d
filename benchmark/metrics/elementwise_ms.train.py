"""Device ms per trained image of the elementwise and reduction class
(norms, activations, decode: ``harness/trace.py::KERNEL_CLASSES``)."""
from benchmark.harness import trace

UNIT = "ms/img"


def read(rec):
    if rec["kind"] != "train":
        return None
    ns = sum(e - s for n, s, e in rec["dev"] if trace.kernel_class(n) == "elementwise_reduce")
    return ns / 1e6 / rec["images"] if ns else None
