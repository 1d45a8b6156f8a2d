"""The plain references the benchmark holds the program to.

A configuration file (``benchmark/configs/<name>.json``) names the module
of its architecture under ``"reference"``; one that names none is
PP-YOLO v1's, ``model``.  ``for_config`` resolves it, so a new
architecture arrives as ``benchmark/reference/<name>.py`` and a
configuration file, with no other file edited.

A reference module gives, in plain PyTorch that imports nothing of the
program, over a flat state dict ``P`` that uses the program's keys:

- ``param_shapes(cfg) -> {key: shape}``: every leaf.  The weights
  (``harness/weights.py``) draw every key ending in ``.conv.weight`` or
  ``.conv.dcn_weight`` as a conv filter, the DCN offset convs (keys
  holding ``.conv_offset.``) small, and BN leaves (``<layer>.bn.weight``,
  ``.bias``, ``.running_mean``, ``.running_var``) by calibration;
- ``OUTPUT_CONVS``: the key prefix of the head's output convs, drawn with
  a small std;
- ``Net(cfg, P, mode, calibrate=None, drop_uniform=None, quant=None,
  stats_sum=None)``, called on normalized NCHW images, returning the raw
  output maps: ``mode`` "eval" (running statistics), "calibrate" (calls
  ``calibrate(layer_key, x, spec)`` with each BN's input before it runs;
  ``spec["act"]`` and ``spec["last_of_branch"]`` say what follows it) or
  "train" (batch statistics, running update, DropBlock uniforms from
  ``drop_uniform(shape)``); ``quant`` rounds every conv's operands;
  ``stats_sum`` (sync-BN, training on ranks) sums each BN's fp32 ``[Σx,
  Σx², count]`` over the ranks;
- ``normalize(cfg, images_u8)``: uint8 NHWC to the network's input;
- ``detect(cfg, P, images_u8, im_size) -> (rows [N, keep_top_k, 6],
  boxes [N, A, 4], scores [N, A, C])``: the served answer and every
  anchor's decoded box and class scores (``reference/compare.py``);
- ``targets(cfg, gt_bbox, gt_class, gt_score, hw, device)`` and
  ``loss(cfg, outputs, targets, gt_bbox) -> {term: scalar}``: the
  training step's (``reference/train.py``);
- ``fp32_exact()`` and ``kaiming_std(shape)`` (``common.py``'s serve);
- optionally ``deform_conv(x, weight, om, stride, pad)``, which
  ``work/counts.py::model_flops`` wraps to record the DCN layers' shapes.
"""
from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "model"


def for_config(cfg_file: dict):
    """The reference module the configuration file names (module
    docstring).  A name with no module exits, naming the file looked for."""
    name = cfg_file.get("reference", DEFAULT)
    mod = f"{__name__}.{name}"
    if mod in sys.modules:
        return sys.modules[mod]
    path = HERE / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(name)) or not path.is_file():
        raise SystemExit(f"no reference named {name!r} (benchmark/reference/{name}.py)")
    return importlib.import_module(mod)
