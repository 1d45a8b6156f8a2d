"""Seeded fp32 weights of a configuration, made on the card.

The recipe keeps a random network well conditioned, as a trained one is,
so that a bf16 forward stays near the fp32 reference and the int8 path
does not (PERF.md, "How `correct` is decided"):

- every conv weight (dense and DCN) is normal, with one weight of each
  filter (at a seeded place, of a seeded sign) ``OUTLIER`` times the
  others' std, the whole filter scaled to the He init's variance
  2 / fan_in: trained filters carry a few large weights, which the int8
  path's per-filter scale pays for on every seed alike;
- the head's output convs (``ref.OUTPUT_CONVS``, which the int8 path
  keeps in bf16) are normal with std 0.01, as RetinaNet and its
  successors initialize the last conv of a detection head: the raw maps
  then have a std near 0.5, so boxes come out in the anchors' range and
  mostly inside the image;
- the DCN offset convs as ``chip_smoke.py`` makes them (bias N(0, 1),
  weight N(0, 1e-3)): fractional, spatially varying offsets;
- the output convs' biases are 0;
- BN is calibrated on one seeded batch at the cell's input size, layer by
  layer in the reference's own forward: the running mean is 0 and the
  running var the channel's mean square, so each channel leaves its BN
  with unit RMS and no mean is subtracted (subtracting a calibrated mean
  from every layer makes a random ReLU network chaotic: a bf16 forward of
  ppyolo_2x then lands 0.4-0.9 relative L2 from fp32); the BN bias is 1
  before an activation, so most units pass it, and the BN weight of each
  residual branch's last conv is 0.3, so the shortcut carries the stream.

All draws come from one ``torch.Generator`` on the card, in a few large
calls.  The configuration's reference module (``reference/__init__.py``)
gives the shapes and makes the calibration pass; nothing of the program
runs.
"""
from __future__ import annotations

from typing import Dict

import torch

OUTLIER = 20.0    # each filter's one large weight, in units of the others' std
OUTPUT_STD = 0.01  # the head's output convs, as detection heads initialize them
BN_BIAS_ACT = 1.0
BRANCH_GAMMA = 0.3


def make_state_dict(ref, cfg, seed: int, device, calib_size: int) -> Dict[str, torch.Tensor]:
    """{key: fp32 tensor on ``device``} of ``cfg``'s model, whose reference
    module is ``ref``, from ``seed``."""
    shapes = ref.param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    wkeys = [k for k in shapes if k.endswith((".conv.weight", ".conv.dcn_weight"))
             and not k.startswith(ref.OUTPUT_CONVS)]
    sizes = [torch.Size(shapes[k]).numel() for k in wkeys]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    rows = sum(shapes[k][0] for k in wkeys)
    spot = torch.rand(rows, generator=gen, device=device)          # each filter's outlier
    sign = torch.randint(0, 2, (rows,), generator=gen, device=device) * 2.0 - 1.0
    P: Dict[str, torch.Tensor] = {}
    r0 = 0
    for k, part in zip(wkeys, torch.split(z, sizes)):
        co = shapes[k][0]
        fan = part.numel() // co
        w = part.view(co, fan).clone()
        pos = (spot[r0:r0 + co] * fan).long().clamp_max(fan - 1)
        w[torch.arange(co, device=device), pos] = OUTLIER * sign[r0:r0 + co]
        r0 += co
        # variance back to the He init's 2 / fan_in
        scale = ref.kaiming_std(shapes[k]) * (fan / (fan - 1 + OUTLIER ** 2)) ** 0.5
        P[k] = (w * scale).view(shapes[k]).contiguous()
    del z
    heads = [k for k in shapes if k.startswith(ref.OUTPUT_CONVS) and k.endswith(".weight")]
    hsizes = [torch.Size(shapes[k]).numel() for k in heads]
    hz = torch.randn(sum(hsizes), generator=gen, device=device)
    for k, part in zip(heads, torch.split(hz, hsizes)):
        P[k] = part.view(shapes[k]) * OUTPUT_STD
    okeys = [k for k in shapes if ".conv_offset." in k]
    osizes = [torch.Size(shapes[k]).numel() for k in okeys]
    o = torch.randn(sum(osizes), generator=gen, device=device)
    for k, part in zip(okeys, torch.split(o, osizes)):
        P[k] = part.view(shapes[k]) * (1.0 if k.endswith("bias") else 1e-3)
    for k, s in shapes.items():
        if k not in P:
            P[k] = (torch.ones(s, device=device) if k.endswith(("bn.weight", "running_var"))
                    else torch.zeros(s, device=device))
    images = torch.randint(0, 256, (2, calib_size, calib_size, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    calibrate(ref, cfg, P, images)
    return P


def calibrate(ref, cfg, P: Dict[str, torch.Tensor], images_u8: torch.Tensor) -> None:
    """Set every BN's statistics and affine from its input in one reference
    forward over ``images_u8`` (module docstring)."""

    def hook(key, x, spec):
        P[f"{key}.bn.running_mean"].zero_()
        P[f"{key}.bn.running_var"].copy_(x.square().mean((0, 2, 3)).clamp_min(1e-6))
        P[f"{key}.bn.bias"].fill_(BN_BIAS_ACT if spec["act"] else 0.0)
        P[f"{key}.bn.weight"].fill_(BRANCH_GAMMA if spec["last_of_branch"] else 1.0)

    with torch.no_grad(), ref.fp32_exact():
        ref.Net(cfg, P, mode="calibrate", calibrate=hook)(ref.normalize(cfg, images_u8))
