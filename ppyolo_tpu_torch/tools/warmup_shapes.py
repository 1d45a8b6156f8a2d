"""Capture the multi-scale train-step CUDA graphs, one per size bucket.

    python -m ppyolo_tpu_torch.tools.warmup_shapes --config 0 [--precision bf16]
        [--scan_steps N] [--sizes 320,608] [--batch_size B] [--use_gpu false]

Counterpart of ``tools/warmup_shapes.py``.  Multi-scale training draws one
of ``cfg.randomShape['sizes']`` per batch (or per ``scan_steps`` batches),
and on the card each size is a CUDA graph of its own, captured at its first
use.  This tool builds the model and train state as the training entry does
(random weights), captures every bucket's graph in turn through the unit
step the entry uses (``train/loop.py::make_unit_step``: a warm-up run on the
live state, then restored, then the capture) and prints the seconds per size
and the total.  On the CPU (``--use_gpu false``) each bucket runs one eager
step instead, the state restored after it.  The entry does the same in
process with ``train_cfg['warmup_shapes']``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def dummy_batch(cfg, size: int, batch_size: int, scan_steps: int = 1) -> Dict[str, np.ndarray]:
    """A batch of one size bucket with the loader's shapes and dtypes (its
    content is irrelevant): uint8 images (or normalized fp32 without
    ``device_normalize``) and padded gt arrays, stacked ``scan_steps``
    times when that is above 1."""
    m = int(cfg.padBox.get("num_max_boxes", 50))
    b = {
        "image": np.zeros((batch_size, size, size, 3), np.uint8),
        "gt_bbox": np.zeros((batch_size, m, 4), np.float32),
        "gt_class": np.zeros((batch_size, m), np.int32),
        "gt_score": np.zeros((batch_size, m), np.float32),
    }
    if not cfg.train_cfg.get("device_normalize", True):
        b["image"] = b["image"].astype(np.float32)
    if scan_steps > 1:
        b = {k: np.stack([v] * scan_steps) for k, v in b.items()}
    return b


def warmup_units(unit_step, cfg, device: torch.device, *, sizes: Iterable[int],
                 scan_steps: int = 1, on_size=None) -> Dict[int, float]:
    """``unit_step.prepare`` on a dummy unit of every size in ``sizes``
    (ascending, each once); ``on_size(size, secs)`` after each.  Returns
    {size: seconds}, each including the unit's copy to the device."""
    from ..data.loader import host_to_device

    times = {}
    for size in sorted(set(int(s) for s in sizes)):
        t0 = time.time()
        unit = host_to_device(dummy_batch(cfg, size, cfg.train_cfg["batch_size"], scan_steps),
                              device)
        unit_step.prepare(unit)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[size] = time.time() - t0
        if on_size is not None:
            on_size(size, times[size])
    return times


def warmup(cfg, *, sizes: Optional[Iterable[int]] = None, scan_steps: int = 1,
           device=None, verbose: bool = True) -> Dict[int, float]:
    """Capture the unit step of ``cfg`` for each size; returns {size: seconds}."""
    from ..models import PPYOLO
    from ..ops.module import resolve_device
    from ..train.loop import PRECISIONS, make_unit_step
    from ..train.train_step import init_train_state

    dev = resolve_device(device)
    tc = cfg.train_cfg
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    generator = torch.Generator(device=dev).manual_seed(1)
    unit_step = make_unit_step(model, cfg, state, generator, n_steps=scan_steps,
                               compute_dtype=PRECISIONS[tc.get("precision", "fp32")])

    def report(size, secs):
        if verbose:
            print(f"  {size}x{size}: prepared in {secs:.1f}s", flush=True)

    times = warmup_units(unit_step, cfg, dev, sizes=sizes or cfg.randomShape["sizes"],
                         scan_steps=scan_steps, on_size=report)
    if verbose:
        print(f"total: {sum(times.values()):.1f}s over {len(times)} buckets")
    return times


def main(argv: Optional[list] = None) -> Dict[int, float]:
    from configs import get_config

    from ..entry.train import str2bool

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True, help="False runs on the host CPU")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=0, help="override cfg batch size")
    p.add_argument("--sizes", default="",
                   help="comma list; default = all cfg.randomShape sizes")
    args = p.parse_args(argv)
    cfg = get_config(args.config)
    cfg.train_cfg["precision"] = args.precision
    if args.batch_size:
        cfg.train_cfg["batch_size"] = args.batch_size
    sizes = [int(s) for s in args.sizes.split(",") if s] or cfg.randomShape["sizes"]
    return warmup(cfg, sizes=sizes, scan_steps=args.scan_steps,
                  device=None if args.use_gpu else "cpu")


if __name__ == "__main__":
    main()
