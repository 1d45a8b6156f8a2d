"""Where K5's time goes: variant builds of ``csrc/conv_int8.cu`` timed at
ppyolo_2x@608 b8's int8 conv shapes, and per-block phase times.

    python -m ppyolo_tpu_torch.tools.k5_probe [--variants exact,no_quant_math] [--phases]

Each variant is a text edit of the kernel's source, written with its
library into ``build/kernels/probe/`` (``csrc/`` is only read), built with
the same nvcc flags, and launched with ``k5_plan``'s plan at each of the
32 shapes (CUDA events over 20 launches, a static scale).  An edit whose
text the kernel no longer holds raises: the edits follow the kernel's
source by hand.  Variants:

  exact          every quotient by ``__fdiv_rn`` (the cost of the division
                 that the reciprocal-and-FMA quotient replaces)
  no_quant_math  the A tile filled with the raw bits instead of their int8
                 (the quantization math's cost; wrong results)
  no_a_loads     nor read from x either (the A tile's loads' cost)
  no_chunk_offset the A tile's loads from channel 0 (the cost of the streamed
                 chunk's offset; right for a resident tile)

``--phases`` builds a copy that stamps ``%globaltimer`` (256 ns steps on
the H100) in each block at its start, after its slot and row tables, after
the A tile (its first chunk's barrier), at its first Co tile's last
product and at its end, and prints for a few shapes the median of each
phase over the blocks.  The card's name is printed with every result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import conv_int8 as ci

BATCH, SIZE, ITERS = 8, 608, 20
_NO_QUANT = [(f"q.{f} = quant4<EXACT>(h[u][{i}], h[u][{i + 1}], sx, rx);",
              f"q.{f} = h[u][{i}] ^ h[u][{i + 1}];") for f, i in zip("xyzw", (0, 2, 4, 6))]
VARIANTS = {
    "exact": [("const bool exact = !(sx >= RCP_LO && sx <= RCP_HI);",
               "const bool exact = true;")],
    "no_quant_math": _NO_QUANT,
    "no_a_loads": _NO_QUANT + [("if (pix >= 0 && c0 + 16 * gq < g.C) {\n        load16",
                                "if (false) {\n        load16")],
    "no_chunk_offset": [("if (pix >= 0 && c0 + 16 * gq < g.C) {\n        load16(x + (long long)pix"
                         " * g.C, c0 + 16 * gq,",
                         "if (pix >= 0 && 16 * gq < g.C) {\n        load16(x + (long long)pix"
                         " * g.C, 16 * gq,")],
}
_PHASES = [
    ('#include "sm90.cuh"\n',
     '#include "sm90.cuh"\n__device__ unsigned long long k5_stamps[6 * 131072];\n'
     '__device__ __forceinline__ unsigned long long gtime() { unsigned long long t; '
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }\n'),
    ("  const int tid = threadIdx.x;\n  const int wg = tid / 128;",
     "  const int tid = threadIdx.x;\n  const unsigned long long t0_ = gtime();\n"
     "  const int wg = tid / 128;"),
    ("    out_tab[r] = pix;\n  }\n  __syncthreads();\n",
     "    out_tab[r] = pix;\n  }\n  __syncthreads();\n  const unsigned long long t1_ = gtime();\n"
     "  unsigned long long t2_ = 0, t3_ = 0;\n"),
    ("          __syncthreads();\n          if (kt + STAGES - 2 < KT) load_next();",
     "          __syncthreads();\n          if (kt == 0) t2_ = gtime();\n"
     "          if (kt + STAGES - 2 < KT) load_next();"),
    ("    sm90::wgmma_wait<0>();\n    const float* const ep =",
     "    sm90::wgmma_wait<0>();\n    if (tile == 0) t3_ = gtime();\n    const float* const ep ="),
    ("  sm90::cp_async_wait<0>();\n}\n",
     "  sm90::cp_async_wait<0>();\n  if (tid == 0) { unsigned long long* d = k5_stamps + "
     "(blockIdx.y * gridDim.x + blockIdx.x) * 6; d[0] = t0_; d[1] = t1_; d[2] = t2_; "
     "d[3] = t3_; d[4] = gtime(); }\n}\n"),
]
_READ_STAMPS = ('\nextern "C" int k5_read_stamps(void* host, int n) {\n'
                '  return (int)cudaMemcpyFromSymbol(host, k5_stamps, (size_t)n * 8);\n}\n')
PHASE_SHAPES = ((76, 512, 256, 1, 1), (38, 1024, 256, 1, 1), (19, 2048, 512, 1, 1),
                (19, 512, 1024, 3, 1), (76, 130, 256, 3, 1), (152, 64, 64, 3, 1))


def variant_source(edits) -> str:
    """The kernel's source with ``edits`` [(old, new)] applied; each old
    text must occur in it."""
    src = (_build.CSRC / "conv_int8.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"k5_probe: {old!r} is not in conv_int8.cu")
        src = src.replace(old, new, 1)
    return src


def build(sources: dict) -> dict:
    """{name: source} -> {name: CDLL}, one nvcc each, in parallel."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = out / f"probe_{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC),   # sm90.cuh
             "-o", str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        libs[name].conv_int8_launch.argtypes = ci._ARGTYPES
        libs[name].conv_int8_launch.restype = ctypes.c_int
    return libs


def _inputs(gen, c, h, w, co, k, stride):
    dev = torch.device("cuda")
    x = (torch.randn(BATCH, c, h, w, generator=gen) * 1.5).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (co, c, k, k), generator=gen, dtype=torch.int8).to(dev)
    ws = (torch.rand(co, generator=gen) * 1e-3 + 1e-4).to(dev)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    y = torch.empty(BATCH, co, oh, ow, dtype=x.dtype, device=dev,
                    memory_format=torch.channels_last)
    p = ci.k5_plan(BATCH, h, w, c, co, k, stride, ci.sm_count(dev))
    keep = (x, ci.pack_int8_weight(wq), ws, ci.dynamic_act_scale(x) * 0.6, y)
    args = (*(t.data_ptr() for t in keep[:4]), 0, y.data_ptr(), BATCH, h, w, c, co, k, stride,
            p.wg_m, p.m_tiles, p.tiles_per_block, p.planes[1], p.planes[2], p.a_slots,
            p.c_chunk, *p.grid, p.smem_bytes, torch.cuda.current_stream().cuda_stream)
    return keep, args, p


def time_ms(fn, args) -> float:
    for _ in range(3):
        if fn(*args) != 0:
            raise RuntimeError("k5_probe: launch failed")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def variants(names) -> None:
    from configs import PPYOLO_2x_Config

    from ..eval.optimize import int8_conv_shapes
    from ..models import PPYOLO

    libs = build({"current": variant_source([]),
                  **{n: variant_source(VARIANTS[n]) for n in names}})
    gen, total = torch.Generator().manual_seed(0), {n: 0.0 for n in libs}
    for c, h, w, co, k, stride, count in int8_conv_shapes(
            PPYOLO.from_config(PPYOLO_2x_Config()).eval(), SIZE, BATCH):
        keep, args, _ = _inputs(gen, c, h, w, co, k, stride)
        row = {n: time_ms(lib.conv_int8_launch, args) for n, lib in libs.items()}
        for n, v in row.items():
            total[n] += count * v
        print(json.dumps({"shape": [BATCH, h, w, c, co, k, stride], "convs": count, **row}))
        del keep
    print(json.dumps({"ms_per_batch": total, "device": torch.cuda.get_device_name(0)}))


def phases() -> None:
    lib = build({"phases": variant_source(_PHASES) + _READ_STAMPS})["phases"]
    gen = torch.Generator().manual_seed(0)
    for h, c, co, k, stride in PHASE_SHAPES:
        keep, args, p = _inputs(gen, c, h, h, co, k, stride)
        ms = time_ms(lib.conv_int8_launch, args)   # the last launch's stamps stay
        n = p.grid[0] * p.grid[1]
        buf = np.zeros(n * 6, np.uint64)
        if lib.k5_read_stamps(buf.ctypes.data_as(ctypes.c_void_p), n * 6) != 0:
            raise RuntimeError("k5_probe: reading the stamps failed")
        d = buf.reshape(n, 6)[:, :5].astype(np.float64) / 1e3   # us
        step = np.diff(d, axis=1)
        print(json.dumps({
            "shape": [BATCH, h, h, c, co, k, stride], "plan": [p.wg_m, p.m_tiles,
                                                                p.tiles_per_block],
            "grid": list(p.grid), "ms": ms, "span_us": float(d[:, 4].max() - d[:, 0].min()),
            **{name: float(np.median(step[:, i])) for i, name in
               enumerate(("tables_us", "a_tile_us", "first_tile_us", "rest_us"))},
            "device": torch.cuda.get_device_name(0)}))
        del keep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    ap.add_argument("--phases", action="store_true", help="per-block phase times instead")
    a = ap.parse_args(argv)
    names = [n for n in a.variants.split(",") if n]
    if not set(names) <= set(VARIANTS):
        raise ValueError(f"--variants {a.variants}: not a subset of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probe runs on the card")
    if a.phases:
        phases()
    else:
        variants(names)


if __name__ == "__main__":
    main()
