"""Export a self-contained serving artifact (a torch.export program, weights baked in).

Counterpart of ``tools/export_serving.py``:

    python -m ppyolo_tpu_torch.tools.export_serving --config 0 --src ppyolo_2x.npz \\
        --out ppyolo_2x_608_b8.pt2 --batch 8 [--size 608] [--precision bf16] \\
        [--dcn plain|kernel] [--stem plain|kernel] [--use_gpu true]

Serve it with PyTorch and this package's operator library alone:

    from ppyolo_tpu_torch.eval.export import load_serving_file
    serve = load_serving_file("ppyolo_2x_608_b8.pt2")
    dets = serve(images_u8, im_size)     # [B, 100, 6], -1-padded

The artifact runs on the device it was exported on (the card, or the CPU
with ``--use_gpu false``); ``--platforms`` of the JAX tool has no
counterpart.  ``--dcn kernel`` / ``--stem kernel`` put K1 / K2 in as
``ppyolo::`` operators (``eval/export.py``).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> str:
    from ..entry.train import str2bool

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--src", default="", help="weights .npz or reference .pt (random init if empty)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=0, help="0 = config test size")
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--dcn", default="plain", choices=["plain", "kernel"],
                   help="DCN in the artifact (plain = PyTorch operators only, portable; "
                        "kernel = K1 as ppyolo::dcn_fwd)")
    p.add_argument("--stem", default="plain", choices=["plain", "kernel"],
                   help="stem in the artifact (plain = the unfused convs; kernel = K2 as "
                        "ppyolo::fused_stem, bf16 only)")
    p.add_argument("--use_gpu", type=str2bool, default=True)
    args = p.parse_args(argv)

    import torch
    from configs import get_config

    from ..checkpoint.convert import load_weights
    from ..eval.detector import Detector
    from ..eval.export import export_detector, save_serving
    from ..models import PPYOLO

    cfg = get_config(args.config)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    if args.src:
        sd = load_weights(args.src, sd)
    det = Detector(model, sd, cfg, precision=args.precision, target_size=args.size or None,
                   device="cuda" if args.use_gpu else "cpu")
    data = export_detector(det, batch=args.batch, dcn=args.dcn, stem=args.stem)
    save_serving(args.out, data)
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB, batch={args.batch}, "
          f"size={det.target_size}, precision={args.precision}, dcn={args.dcn}, "
          f"stem={args.stem}, device={det.device}")
    return args.out


if __name__ == "__main__":
    main()
