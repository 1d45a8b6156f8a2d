"""Reproduce a profiled replay after graphs were destroyed and their memory freed.

    python -m ppyolo_tpu_torch.tools.graph_teardown [--model 2x|mini2x]
        [--size 608] [--batch 8] [--steps 4] [--sessions 3]

The program: one torch.profiler session; the capture (``GraphedStep``) of
a one-step fine-tuning unit and of a ``--steps``-step unit that share a
registered generator (DropBlock draws from it); one replay of each; the
destruction of the multi-step unit (``del``, ``gc.collect()``,
``torch.cuda.empty_cache()``); then ``--sessions`` replays of the one-step
unit, each inside a profiler session of its own, whose trace must hold
the K1 launches the counter counts.  Before ``train/graphs.py`` kept its
memory pools, the second such replay segfaulted inside CUPTI's
graph-launch callback at ppyolo_2x@608 b8 (the default).  Prints one JSON
line and exits 0 when every replay ran; a crash kills the process, so run
it in a subprocess (``tests/test_torch_port_gpu.py``).  Needs a card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch


def _config(model: str, batch: int):
    from configs import PPYOLO_2x_Config

    cfg = PPYOLO_2x_Config()
    if model == "mini2x":
        cfg.num_classes = 2
        cfg.backbone_type = "Resnet18Vd"
        cfg.backbone = dict(norm_type="bn", feature_maps=[3, 4, 5], dcn_v2_stages=[5],
                            norm_decay=0.0)
        cfg.head = dict(cfg.head, num_classes=2, in_channels=[512, 256, 128])
        cfg.gt2YoloTarget = dict(cfg.gt2YoloTarget, num_classes=2)
    cfg.backbone = dict(cfg.backbone, freeze_at=0)
    cfg.train_cfg = dict(cfg.train_cfg, batch_size=batch, precision="bf16")
    return cfg


def _batch(cfg, seed: int, batch: int, size: int, dev) -> dict:
    r = np.random.RandomState(seed)
    gt_bbox = np.zeros((batch, 50, 4), np.float32)
    gt_bbox[:, :8, 0:2] = r.uniform(0.2, 0.8, (batch, 8, 2))
    gt_bbox[:, :8, 2:4] = r.uniform(0.05, 0.4, (batch, 8, 2))
    gt_score = np.zeros((batch, 50), np.float32)
    gt_score[:, :8] = 1.0
    b = {"image": r.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
         "gt_bbox": gt_bbox,
         "gt_class": r.randint(0, cfg.num_classes, (batch, 50)).astype(np.int32),
         "gt_score": gt_score}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="2x", choices=["2x", "mini2x"])
    p.add_argument("--size", type=int, default=608)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--sessions", type=int, default=3)
    args = p.parse_args(argv)

    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import (init_train_state, make_multi_train_step,
                                                   make_train_step)
    from ppyolo_tpu_torch.utils.profiling import device_trace

    if not torch.cuda.is_available():
        print("graph_teardown needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def profiled(fn) -> int:
        before = dcn_fwd.launches
        with device_trace() as prof:
            fn()
            torch.cuda.synchronize()
        traced = sum(e.count for e in prof.key_averages() if "dcn_fwd_kernel" in e.key)
        if traced != dcn_fwd.launches - before:
            raise AssertionError(f"trace holds {traced} K1 launches, the counter "
                                 f"{dcn_fwd.launches - before}")
        return traced

    x = torch.ones(1024, device=dev)
    profiled(lambda: x.mul_(2))                       # CUPTI is set up from here on
    cfg = _config(args.model, args.batch)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    batches = [_batch(cfg, 20 + i, args.batch, args.size, dev) for i in range(args.steps)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    one = GraphedStep(make_train_step(model, cfg, compute_dtype=torch.bfloat16), state, gen)
    multi = GraphedStep(make_multi_train_step(model, cfg, n_steps=args.steps,
                                              compute_dtype=torch.bfloat16),
                        state, gen, n_steps=args.steps)
    one(state, batches[0])
    multi(state, stacked)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    del multi
    gc.collect()
    torch.cuda.empty_cache()
    traced = [profiled(lambda: one(state, batches[i % len(batches)]))
              for i in range(args.sessions)]
    print(json.dumps({"tool": "graph_teardown", "ok": True, "model": args.model,
                      "size": args.size, "batch": args.batch, "steps": args.steps,
                      "k1_per_session": traced, "reserved_gb_before_destroy": reserved / 1e9,
                      "reserved_gb_after": torch.cuda.memory_reserved() / 1e9,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
