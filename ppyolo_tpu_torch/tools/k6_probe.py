"""Where K6's time goes: variant builds of ``csrc/nms_keep.cu`` timed on
clustered candidates at b8 (``kernel_ab.nms_candidates``), k = 500 and 1500.

    python -m ppyolo_tpu_torch.tools.k6_probe [--variants division,no_far_updates]

Each variant is a text edit of the kernel's source, written with its
library into ``build/kernels/probe_k6/`` (``csrc/`` is only read), built
with the same nvcc flags and timed in a CUDA graph of 20 launches
(``kernel_ab.graph_ms``), beside the current source built the same way.
The variants that compute the same function are held bit-equal to the
plain version; the others time a part by leaving it out.  An edit whose
text the kernel no longer holds raises: the edits follow the source by
hand.  Variants:

  group_1         a lane's candidates tested one at a time (``suppressors``)
                  instead of four
  group_8         eight at a time
  word_a_warp     each later chunk tested against all of a chunk's kept
                  boxes by one warp, never in shares over the warps
  all_shares      a chunk's kept boxes always in shares of GROUP, however
                  many later chunks there are
  no_cull         the IoU of every pair of one label, also of boxes that do
                  not overlap (``may_suppress`` without its overlap test)
  threads_512     512 threads a block (16 warps) instead of 1024
  no_far_updates  the later chunks never tested against a chunk's kept
                  boxes (their cost; wrong keep flags)
  no_masks        no IoU in the first phase: the diagonal and previous-chunk
                  masks left empty (their cost; wrong keep flags)

The card's name and power limit are printed with every result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import _build
from ..ops.matrix_nms import _KEEP_ARGTYPES, nms_keep_boxes_plain
from .kernel_ab import NMS_THR, graph_ms, nms_candidates

SHAPES = ((8, 500), (8, 1500))
VARIANTS = {
    "group_1": ([("constexpr int GROUP = 4;", "constexpr int GROUP = 1;")], True),
    "group_8": ([("constexpr int GROUP = 4;", "constexpr int GROUP = 8;")], True),
    "word_a_warp": ([("const int shares = min(", "const int shares = 1 + 0 * min(")], True),
    "all_shares": ([("max(1, WARPS / max(later, 1)));", "32);")], True),
    "no_cull": ([("(thr < 0.f || (fminf", "(true || (fminf")], True),
    "threads_512": ([("constexpr int THREADS = 1024;", "constexpr int THREADS = 512;")], True),
    "no_far_updates": ([("    if (kp != 0u) {", "    if (false) {")], False),
    "no_masks": ([("const bool open = i < k && ((vbits[c] >> lane) & 1u);",
                   "const bool open = false;")], False),
}


def variant_source(edits) -> str:
    """The kernel's source with ``edits`` [(old, new)] applied; each old
    text must occur in it."""
    src = (_build.CSRC / "nms_keep.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"k6_probe: {old!r} is not in nms_keep.cu")
        src = src.replace(old, new, 1)
    return src


def build(sources: dict) -> dict:
    """{name: source} -> {name: CDLL}, one nvcc each, in parallel."""
    out = _build.BUILD_DIR / "probe_k6"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = out / f"probe_{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.nms_keep_launch.argtypes = _KEEP_ARGTYPES
        lib.nms_keep_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    a = ap.parse_args(argv)
    names = a.variants.split(",")
    if not set(names) <= set(VARIANTS):
        raise ValueError(f"--variants {a.variants}: not a subset of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probe runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build({"current": variant_source([]),
                  **{n: variant_source(VARIANTS[n][0]) for n in names}})
    dev, rows = torch.device("cuda"), []
    for b, k in SHAPES:
        valid, boxes, labels = nms_candidates(torch.Generator().manual_seed(0), b, k, dev)
        want = nms_keep_boxes_plain(valid, boxes, labels, NMS_THR)
        for name, lib in libs.items():
            keep = torch.empty_like(valid)

            def run():
                if lib.nms_keep_launch(valid.data_ptr(), boxes.data_ptr(), labels.data_ptr(),
                                       keep.data_ptr(), None, b, k, NMS_THR,
                                       torch.cuda.current_stream().cuda_stream) != 0:
                    raise RuntimeError(f"k6_probe {name}: launch failed")

            run()
            torch.cuda.synchronize()
            exact = name == "current" or VARIANTS[name][1]
            same = bool(torch.equal(keep, want))
            if exact and not same:
                raise AssertionError(f"k6_probe {name} b{b} k{k}: keep flags differ from the "
                                     f"plain version")
            rows.append({"variant": name, "b": b, "k": k, "ms": graph_ms(run, 20),
                         "bit_equal": same, "nvidia_smi": smi})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
