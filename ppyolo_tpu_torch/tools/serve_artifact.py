"""Serve detections from an exported artifact, without the model's code or weights.

Counterpart of ``tools/serve_artifact.py``:

    python -m ppyolo_tpu_torch.tools.serve_artifact --artifact ppyolo_2x_608_b8.pt2 \\
        --image_dir images/test --out detections.json [--draw_dir out/] \\
        [--score_thresh 0.15] [--use_gpu true]

The artifact fixes (batch, size): images are resized to uint8 on the host
(``Detector.process_image``'s contract), served in chunks of the batch (the
last one padded by repetition, so any number of images goes through), and
the [B, keep_top_k, 6] rows are written as one JSON list of {image, label,
score, bbox (xyxy, original-image coordinates)}.  Unreadable images are
skipped with a warning.  The artifact runs on the device it was exported
on: ``--use_gpu false`` refuses an artifact exported on the card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    from ..entry.train import str2bool

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--artifact", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out", default="detections.json")
    p.add_argument("--draw_dir", default="")
    p.add_argument("--score_thresh", type=float, default=0.15)
    p.add_argument("--interp", default="cubic",
                   choices=["nearest", "linear", "cubic", "area", "lanczos"],
                   help="host resize interpolation: the exporting config's "
                        "resizeImage['interp'] (cubic for every shipped config)")
    p.add_argument("--use_gpu", type=str2bool, default=True)
    args = p.parse_args(argv)

    import cv2
    import torch

    from ..eval.export import input_spec, load_program, program_device, serving_fn

    interp = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR,
              "cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA,
              "lanczos": cv2.INTER_LANCZOS4}[args.interp]
    with open(args.artifact, "rb") as f:
        program = load_program(f.read())
    batch, size = input_spec(program)
    device = program_device(program)
    if device.type == "cuda" and not (args.use_gpu and torch.cuda.is_available()):
        raise SystemExit(f"{args.artifact} was exported on {device}: it needs a CUDA card")
    serve = serving_fn(program)

    files = sorted(f for f in glob.glob(os.path.join(args.image_dir, "*"))
                   if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    if not files:
        raise SystemExit(f"no images in {args.image_dir}")

    results, skipped = [], []
    for i in range(0, len(files), batch):
        chunk, ims, sizes = [], [], []
        for f in files[i:i + batch]:
            bgr = cv2.imread(f)
            if bgr is None:
                skipped.append(f)
                continue
            chunk.append(f)
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            sizes.append([bgr.shape[0], bgr.shape[1]])
            ims.append(cv2.resize(rgb, (size, size), interpolation=interp))
        if not chunk:
            continue
        while len(ims) < batch:          # pad the tail by repetition
            ims.append(ims[-1])
            sizes.append(sizes[-1])
        dets = serve(np.stack(ims).astype(np.uint8), np.asarray(sizes, np.float32))
        for f, d in zip(chunk, dets):
            keep = (d[:, 0] >= 0) & (d[:, 1] >= args.score_thresh)
            for row in d[keep]:
                results.append({"image": os.path.basename(f), "label": int(row[0]),
                                "score": float(row[1]), "bbox": [float(v) for v in row[2:6]]})
            if args.draw_dir:
                os.makedirs(args.draw_dir, exist_ok=True)
                img = cv2.imread(f)
                for row in d[keep]:
                    x0, y0, x1, y1 = (int(v) for v in row[2:6])
                    cv2.rectangle(img, (x0, y0), (x1, y1), (0, 255, 0), 1)
                cv2.imwrite(os.path.join(args.draw_dir, os.path.basename(f)), img)

    with open(args.out, "w") as f:
        json.dump(results, f)
    for f in skipped:
        print(f"WARNING: unreadable image skipped: {f}", file=sys.stderr)
    print(f"{len(files) - len(skipped)} images -> {len(results)} detections -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
