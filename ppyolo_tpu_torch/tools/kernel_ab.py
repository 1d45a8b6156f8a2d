"""Time K4 and K2 against an earlier build of the same kernels, kernel alone.

Both versions get the same inputs at the shapes their paths give them (K4:
the probe's stage3_0 and stage4_0 convs, K2: a b8@608 batch; bf16), with
their weights packed once, outside the timed window, in the layout each
reads.  Each is held against the plain version first (max-abs error <= 2%
of the plain output's max-abs), then timed with CUDA events over 20 warm
launches in the order earlier, current, current, earlier.

The earlier version is given as a directory of CUDA sources with the C
interface of the wmma kernels that preceded the wgmma redesign:

  conv_s2_launch(x, w, y, is_f32, N, H, W, C, Co, stream), w [9*C, Co]
  fused_stem_launch(x, w1, b1, w2, b2, w3, b3, y, N, H, W, stream),
      w1 fp32 and w2, w3 bf16, all HWIO; b1, b2, b3 fp32

e.g. an earlier commit's ``ppyolo_tpu_torch/csrc`` unpacked with
``git archive``.  It is built with the same nvcc flags into
``build/kernels/earlier/``.

Usage: python -m ppyolo_tpu_torch.tools.kernel_ab --earlier DIR
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.stem import fused_stem, fused_stem_plain, pack_stem_params
from ..ops.strided_conv import conv_s2, conv_s2_phase, pack_conv_s2_weight
from .probe_strided_conv import SHAPES

BATCH, SIZE, TOL, ITERS = 8, 608, 0.02, 20
_EARLIER_ARGTYPES = {
    "conv_s2": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "fused_stem": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def build_earlier(src_dir: Path) -> dict:
    """Compile the earlier conv_s2.cu and fused_stem.cu; their launch functions."""
    out = _build.BUILD_DIR / "earlier"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"),
         str(src_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in _EARLIER_ARGTYPES}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src_dir / name}.cu failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), f"{name}_launch")
        fn.argtypes = _EARLIER_ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def check(name: str, got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= TOL * float(want.float().abs().max()):
        raise AssertionError(f"{name}: max-abs error {err} against the plain version")
    return err


def ab(name: str, earlier, current) -> dict:
    """earlier, current, current, earlier; each side's mean of its two."""
    e1, c1, c2, e2 = cuda_ms(earlier), cuda_ms(current), cuda_ms(current), cuda_ms(earlier)
    return {"kernel": name, "earlier_ms": [e1, e2], "current_ms": [c1, c2],
            "speedup": (e1 + e2) / (c1 + c2)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="directory with the earlier conv_s2.cu and fused_stem.cu")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the A/B runs on the card")
    earlier = build_earlier(a.earlier)
    dev, bf = torch.device("cuda"), torch.bfloat16
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator().manual_seed(0)
    rows = []

    for sname, h, c, co in SHAPES:
        x = torch.randn(BATCH, h, h, c, generator=gen).to(dev, bf).permute(0, 3, 1, 2)
        w = (torch.randn(co, c, 3, 3, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dev, bf)
        packed = pack_conv_s2_weight(w)
        packed_earlier = w.permute(2, 3, 1, 0).reshape(9 * c, co).contiguous()
        y = torch.empty(BATCH, co, h // 2, h // 2, dtype=bf, device=dev,
                        memory_format=torch.channels_last)
        xh = x.permute(0, 2, 3, 1)
        run_e = lambda: earlier["conv_s2"](xh.data_ptr(), packed_earlier.data_ptr(),
                                           y.data_ptr(), 0, BATCH, h, h, c, co, stream())
        run_c = lambda: conv_s2(x, w, packed=packed)
        want = conv_s2_phase(x, w)
        if run_e() != 0:
            raise RuntimeError("earlier conv_s2 launch failed")
        errs = {"earlier": check(f"earlier conv_s2 {sname}", y, want),
                "current": check(f"conv_s2 {sname}", run_c(), want)}
        rows.append({**ab(f"conv_s2 {sname}", run_e, run_c), "max_abs_err": errs})

    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=gen).to(dev, bf)
    x = x.contiguous(memory_format=torch.channels_last)
    ws = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        ws.append((torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (cin * 9)) ** 0.5)
                  .to(dev, bf))
        ws.append((torch.randn(cout, generator=gen) * 0.1).to(dev))
    packed = pack_stem_params(*ws)
    hwio = [wt.to(dt).permute(2, 3, 1, 0).contiguous()
            for wt, dt in ((ws[0], torch.float32), (ws[2], bf), (ws[4], bf))]
    biases = [b.float().contiguous() for b in ws[1::2]]
    y = torch.empty(BATCH, 64, SIZE // 4, SIZE // 4, dtype=bf, device=dev,
                    memory_format=torch.channels_last)
    xh = x.permute(0, 2, 3, 1)
    args_e = [xh.data_ptr()] + [t.data_ptr() for pair in zip(hwio, biases) for t in pair]
    run_e = lambda: earlier["fused_stem"](*args_e, y.data_ptr(), BATCH, SIZE, SIZE, stream())
    run_c = lambda: fused_stem(x, *ws, packed=packed)
    want = fused_stem_plain(x, *ws)
    if run_e() != 0:
        raise RuntimeError("earlier fused_stem launch failed")
    errs = {"earlier": check("earlier fused_stem", y, want),
            "current": check("fused_stem", run_c(), want)}
    rows.append({**ab("fused_stem b8@608", run_e, run_c), "max_abs_err": errs})

    name = torch.cuda.get_device_name(dev)
    for r in rows:
        print(json.dumps({**r, "device": name}), flush=True)
    return rows


if __name__ == "__main__":
    main()
