"""Per-op and per-conv profile of the serving program.

Counterpart of ``tools/profile_serving.py``:

    python -m ppyolo_tpu_torch.tools.profile_serving [--config 0] [--batch 8]
        [--size 608] [--precision bf16] [--iters 20] [--top 30]
        [--stage full|backbone|head] [--use_gpu true]

Three outputs, for the Detector's serving form (BN folded, cast) with
random weights from a seed:

1. stage ablation: backbone / +head (raw maps) / +decode+NMS, device ms a
   batch, each stage one CUDA graph replayed ``--iters`` times over two
   input batches in turn and timed with CUDA events (wall ms on the CPU);
2. hot ops: device time by kernel from a torch.profiler trace of
   ``--profile_iters`` eager runs of the chosen stage;
3. per-conv utilization: the profiler's own FLOPs of each conv and matrix
   product (``utils/profiling.py::conv_flops_from_profile``) joined with
   the same trace's kernel times, against the card's bf16 peak from
   ``utils/mfu.py`` (none on the CPU, where the table lists FLOPs and
   times only).

``main`` returns the three as a dict (``chip_smoke.py``'s
``profile_serving`` phase prints the top convs from it).
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

STAGES = ("backbone", "head", "full")


def _stage_fns(det):
    m = det.model
    return {"backbone": lambda x, s: {f"f{i}": f for i, f in enumerate(m.backbone(x))},
            "head": lambda x, s: {f"o{i}": o for i, o in enumerate(m.outputs(x))},
            "full": lambda x, s: {"det": m.predict(x, s)}}


def main(argv=None) -> dict:
    from ..entry.train import str2bool
    from ..eval.detector import Detector
    from ..models import PPYOLO
    from ..ops.module import resolve_device
    from ..train.graphs import GraphPool, Graphs
    from ..utils.mfu import peak_flops_per_chip
    from ..utils.profiling import (conv_flops_from_profile, conv_utilization_table, cuda_ms,
                                   timeit_sync, trace, trace_op_times)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=608)
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--iters", type=int, default=20, help="timed replays a stage")
    p.add_argument("--profile_iters", type=int, default=3, help="eager runs in the trace")
    p.add_argument("--stage", default="full", choices=STAGES)
    p.add_argument("--trace_dir", default=os.path.join("build", "profile_serving"))
    p.add_argument("--skip_ablation", action="store_true")
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)

    from configs import get_config

    dev = resolve_device(None if args.use_gpu else "cpu")
    cfg = get_config(args.config)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), cfg, target_size=args.size,
                   precision=args.precision, device=dev)
    b, s = args.batch, args.size
    rng = np.random.RandomState(0)
    images = [det.normalize(torch.from_numpy(rng.randint(0, 256, (b, s, s, 3), dtype=np.uint8))
                            .to(dev)) for _ in range(2)]
    sizes = torch.tensor([[480.0, 640.0]] * b, device=dev)
    fns = _stage_fns(det)
    pool = GraphPool.get(dev) if dev.type == "cuda" else None
    out = {"config": args.config, "batch": b, "size": s, "precision": args.precision,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    if not args.skip_ablation:
        ms = {}
        for name in STAGES:
            units = Graphs(lambda inp, f=fns[name]: f(inp["x"], inp["s"]), dev, pool=pool,
                           model=det.model)
            it = iter(range(10 ** 9))
            run = lambda: units({"x": images[next(it) % 2], "s": sizes})  # noqa: E731
            with torch.no_grad():
                ms[name] = (cuda_ms(run, args.iters) if dev.type == "cuda"
                            else 1e3 * timeit_sync(run, iters=args.iters, warmup=1))
            units.release()
        out["ablation_ms"] = ms
        out["img_per_s"] = 1e3 * b / ms["full"]
        print(f"ablation b{b}@{s} {args.precision} (ms a batch, {args.iters} replays):")
        print(f"  backbone          {ms['backbone']:8.3f}")
        print(f"  +head (raw maps)  {ms['head']:8.3f}  (+{ms['head'] - ms['backbone']:.3f})")
        print(f"  +decode+NMS       {ms['full']:8.3f}  (+{ms['full'] - ms['head']:.3f})")
        print(f"  img/s             {out['img_per_s']:8.1f}")

    shutil.rmtree(args.trace_dir, ignore_errors=True)   # stale traces would sum in
    fn = fns[args.stage]
    with torch.no_grad():
        fn(images[0], sizes)
        with trace(args.trace_dir) as prof:
            for i in range(args.profile_iters):
                fn(images[i % 2], sizes)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    times = trace_op_times(args.trace_dir)
    total = sum(times.values())
    hot = sorted(times.items(), key=lambda kv: -kv[1])[:args.top]
    n = args.profile_iters
    out["hot"] = [{"name": k[:100], "ms": v / n, "share": v / max(total, 1e-12)} for k, v in hot]
    print(f"\nhot ops ({args.stage}, ms a batch over {n} eager runs):")
    for row in out["hot"]:
        print(f"  {row['ms']:9.3f} ms  {row['share']:6.1%}  {row['name']}")

    peak = peak_flops_per_chip(dev)
    convs = conv_flops_from_profile(prof)
    # ``repeat``: the trace's times sum n runs, and so do the profiler's FLOPs
    rows, n_convs = conv_utilization_table(times, convs, peak=peak or 1.0, repeat=1)
    out["peak_flops"] = peak
    out["convs"] = [{"ms": ms_ / n, "util": util if peak else None, "gflop": fl / n / 1e9,
                     "shapes": shape[:200], "kernel": name[:100]}
                    for ms_, util, fl, shape, name in rows]
    label = f"peak {peak / 1e12:.0f} TFLOP/s" if peak else "peak unknown"
    print(f"\nper-conv utilization ({args.stage}; {len(rows)} kernels of {n_convs} with conv "
          f"or matmul FLOPs; {label}):")
    for row in out["convs"][:args.top]:
        util = f"{row['util']:6.1%}" if row["util"] is not None else "     -"
        print(f"  {row['ms']:9.3f} ms {util}  {row['gflop']:8.2f} GFLOP  {row['kernel']}")
    if rows:
        tot_ms = sum(r["ms"] for r in out["convs"])
        tot_fl = sum(r["gflop"] for r in out["convs"]) * 1e9
        out["convs_total"] = {"ms": tot_ms, "tflop": tot_fl / 1e12,
                              "util": tot_fl / (tot_ms / 1e3) / peak if peak else None}
        print(f"  convs total: {tot_ms:.3f} ms, {tot_fl / 1e12:.3f} TFLOP a batch")
    return out


if __name__ == "__main__":
    main()
