"""Rank 0's exposed exchange in training, device ms a step: the time in
which a kernel whose name starts with ``nccl`` runs and no other device
record (kernel, copy or memset) does, over the traced steps.  The part of
the sync-BN statistics and gradient all-reduces that an overlap with
compute could hide.  None where no NCCL kernel ran (one card)."""
import bisect

from benchmark.harness import trace

UNIT = "ms/step"


def read(rec):
    nccl = trace.union([(s, e) for n, s, e in rec["dev"] if n.startswith("nccl")])
    if rec["kind"] != "train" or not nccl:
        return None
    other = trace.union([(s, e) for n, s, e in rec["dev"] if not n.startswith("nccl")])
    starts = [a for a, _ in other]
    exposed = 0
    for s, e in nccl:
        exposed += e - s
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(other) and other[j][0] < e:
            exposed -= max(0, min(e, other[j][1]) - max(s, other[j][0]))
            j += 1
    return exposed / 1e6 / rec["steps"]
