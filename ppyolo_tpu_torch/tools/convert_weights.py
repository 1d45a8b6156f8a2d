"""Convert reference checkpoints into the npz format both packages read.

Counterpart of ``tools/convert_weights.py``: reads the Paddle
``ppyolo.pdparams`` (the reference converters' name contract) or the
reference's ``ppyolo_2x.pt`` torch state dict, and writes ``--out`` as an
npz in the JAX package's format (``checkpoint/io.py::save_params_npz``:
dotted param paths, HWIO conv kernels).  Leaves the file does not give
keep the port's seed-0 initialisation.  The conversion is renaming, so it
runs on the CPU.

    python -m ppyolo_tpu_torch.tools.convert_weights --config 0 --src ppyolo.pdparams \\
        --out ppyolo_2x.npz
    python -m ppyolo_tpu_torch.tools.convert_weights --config 1 --src ppyolo_r18vd.pt \\
        --out ppyolo_r18vd.npz
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_classes", type=int, default=80,
                   help="pretrained checkpoints are COCO-80 (the reference converter forces 80)")
    args = p.parse_args(argv)

    from configs import get_config

    from ..checkpoint.convert import (convert_paddle_state_dict, convert_torch_state_dict,
                                      load_paddle_state_dict, load_torch_state_dict)
    from ..checkpoint.io import save_params_npz
    from ..models import PPYOLO

    cfg = get_config(args.config)
    cfg.num_classes = args.num_classes
    cfg.head = dict(cfg.head, num_classes=args.num_classes)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    if args.src.endswith(".pt"):
        sd = convert_torch_state_dict(load_torch_state_dict(args.src), model)
    else:
        sd = convert_paddle_state_dict(load_paddle_state_dict(args.src), model)
    save_params_npz(args.out, sd)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
