"""YOLOv3 FPN head with the PP-YOLO tricks.

Counterpart of ``ppyolo_tpu/models/head.py`` (``DetectionBlock``,
``YOLOv3Head.get_outputs`` / ``get_prediction``): CoordConv, SPP on the
first block, transition 1x1 + nearest 2x upsample + route concat, the
IoU-aware decode and batched Matrix-NMS, or multiclass (hard) NMS when
``nms_cfg['nms_type']`` is ``'multiclass_nms'`` (``head.py:327-330``).
The paramless CoordConv / SPP / DropBlock slots consume ``layers``
indices, so the keys match the JAX param tree
(``detection_blocks.0.layers.1.conv.weight``), and each conv carries the
Paddle name the JAX head gives it (``yolo_block.0.0.0``, ``yolo_output.0
.conv``) for the ``.pdparams`` converter.

The concats can be virtual (``head_decompose``, the JAX package's
``HEAD_DECOMPOSE``, ``head.py:32-45``): a conv over a list of parts sums
one conv per part (``ConvNormAct.forward_parts``) and the concat is never
written.  ``off`` materializes every concat with ``torch.cat``; ``inner``
keeps the CoordConv planes (batch-1, their term computed once per grid)
and the SPP pyramid virtual but writes the route || backbone concat;
``on`` keeps the route concat virtual too.  ``auto`` is ``off`` in
training and in fp32 (the fused conv's summation order) and
``AUTO_EVAL_BF16`` for eval-mode bf16, chosen by an H100 A/B of the three
at ppyolo_2x@608 b8 (``chip_smoke.py``'s ``graphs_serving``; PERF.md):
``inner`` and ``on`` both serve 12-16% faster than ``off`` and lie within
each other's run-to-run spread, and the tie goes to ``inner``, the JAX
package's mode, so the port sums as the reference does.  int8 and DCN convs take the materialized form
(``ConvNormAct.forward_parts``).  The mode is read when the forward runs,
so a captured CUDA graph holds one mode (``Detector`` keys its graphs by
it).  DropBlock runs in training only (``head.py:143-147``), drawing from the
generator handed to ``get_outputs``.  The decode's anchors are a
non-persistent integer buffer (pixel sizes, exact under the serving
model's bf16 cast), so they move with the model and the predict makes no
host-to-device copy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..ops.blocks import coord_conv, coord_planes, drop_block, spp, spp_parts, upsample_nearest_2x
from ..ops.conv import ConvNormAct, param_policy_tree
from ..ops.module import make_contextvar_override
from ..ops.matrix_nms import matrix_nms, multiclass_nms
from ..ops.yolo_box import yolo_box_serving


HEAD_DECOMPOSE, head_decompose = make_contextvar_override(
    "HEAD_DECOMPOSE", ("auto", "on", "off", "inner"), "auto")
AUTO_EVAL_BF16 = "inner"


def decompose_mode(training: bool, dtype: torch.dtype) -> str:
    """The head's virtual-concat mode for a forward: ``head_decompose``'s
    value, with ``auto`` resolved (module docstring)."""
    mode = HEAD_DECOMPOSE.get()
    if mode == "auto":
        mode = AUTO_EVAL_BF16 if not training and dtype == torch.bfloat16 else "off"
    return mode


class DetectionBlock(nn.Module):
    """One FPN level body (reference head.py:146-239)."""

    def __init__(self, in_c, channel, *, coord=True, norm="bn", conv_block_num=2,
                 is_first=False, use_spp=True, drop_blk=True, block_size=3,
                 keep_prob=0.9, paddle_name=""):
        super().__init__()
        assert channel % 2 == 0
        self.coord = coord
        self.block_size, self.keep_prob = block_size, keep_prob
        seq = []                       # (kind, key): coord | conv | spp | drop
        layers = {}

        def add(kind, mod=None):
            key = str(len(seq))
            if mod is not None:
                layers[key] = mod
            seq.append((kind, key))

        def conv(cin, cout, k, pname):
            m = ConvNormAct(cin, cout, k, norm=norm, act="leaky")
            m.paddle_name = f"{paddle_name}.{pname}"
            return m

        c = in_c
        for j in range(conv_block_num):
            add("coord")
            add("conv", conv(c + 2 if coord else c, channel, 1, f"{j}.0"))
            if use_spp and is_first and j == 1:
                add("spp")
                add("conv", conv(channel * 4, 512, 1, f"{j}.spp.conv"))
                add("conv", conv(512, channel * 2, 3, f"{j}.1"))
            else:
                add("conv", conv(channel, channel * 2, 3, f"{j}.1"))
            if drop_blk and j == 0 and not is_first:
                add("drop")
            c = channel * 2
        if drop_blk and is_first:
            add("drop")
        add("coord")
        cc = c if conv_block_num == 0 else channel * 2
        add("conv", conv(cc + 2 if coord else cc, channel, 1, "2"))
        self.seq = seq
        self.layers = nn.ModuleDict(layers)
        self.tip_layers = nn.ModuleDict({"1": conv(channel + 2 if coord else channel,
                                                   channel * 2, 3, "tip")})

    def forward(self, x, generator: Optional[torch.Generator] = None, *,
                decompose: bool = False):
        """``x`` a tensor, or with ``decompose`` a list of channel parts (the
        route concat left virtual); the CoordConv and SPP concats stay
        virtual under ``decompose`` and every conv output is one tensor
        again (``ppyolo_tpu/models/head.py:122-160``).  Returns (route, tip)."""
        coord = False   # is the last part of x the CoordConv planes?
        for kind, key in self.seq:
            if kind == "coord" and self.coord:
                if decompose:
                    ps = x if isinstance(x, list) else [x]
                    x = ps + [self._planes(ps[0])]
                    coord = True
                else:
                    x = coord_conv(x)
            elif kind == "conv":
                m = self.layers[key]
                x = m.forward_parts(x, coord=coord) if isinstance(x, list) else m(x)
                coord = False
            elif kind == "spp":
                x = spp_parts(x) if decompose else spp(x)
            elif kind == "drop" and self.training:
                x = drop_block(x, generator, block_size=self.block_size,
                               keep_prob=self.keep_prob)
        route = x
        tip_conv = self.tip_layers["1"]
        if not self.coord:
            tip = tip_conv(route)
        elif decompose:
            tip = tip_conv.forward_parts([route, self._planes(route)], coord=True)
        else:
            tip = tip_conv(coord_conv(route))
        return route, tip

    @staticmethod
    def _planes(x: torch.Tensor) -> torch.Tensor:
        return coord_planes(x.shape[2], x.shape[3], x.dtype, x.device)


class YOLOv3Head(nn.Module):
    """Reference YOLOv3Head (head.py:242-469)."""

    def __init__(self, num_classes=80, conv_block_num=2,
                 anchors=((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
                          (116, 90), (156, 198), (373, 326)),
                 anchor_masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)), norm_type="bn",
                 coord_conv=True, iou_aware=True, iou_aware_factor=0.4,
                 scale_x_y=1.05, spp=True, drop_block=True, block_size=3,
                 keep_prob=0.9, clip_bbox=True, downsample=(32, 16, 8),
                 in_channels=(2048, 1024, 512), nms_cfg=None, **_unused):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_masks = [list(m) for m in anchor_masks]
        mask_wh = np.asarray([anchors[a] for m in anchor_masks for a in m], np.float64)
        if not np.array_equal(mask_wh, np.round(mask_wh)):
            raise ValueError(f"anchors must be integral pixel sizes, got {anchors}")
        # level i's anchors are rows [start, start + len(mask)) in mask order
        self.register_buffer("mask_anchors_wh", torch.from_numpy(mask_wh.astype(np.int32)),
                             persistent=False)
        self._mask_rows = np.cumsum([0] + [len(m) for m in anchor_masks]).tolist()
        self.mask_anchors = [[float(v) for a in m for v in anchors[a]]
                             for m in anchor_masks]
        self.iou_aware = iou_aware
        self.iou_aware_factor = iou_aware_factor
        self.scale_x_y = scale_x_y
        self.clip_bbox = clip_bbox
        self.downsample = list(downsample)
        self.nms_cfg = dict(nms_cfg or {})
        self.n_levels = n = len(downsample)
        blocks, outs, trans = [], [], {}
        for i in range(n):
            in_c = in_channels[i] + (512 // (2 ** i) if i > 0 else 0)
            channel = 64 * (2 ** n) // (2 ** i)
            blocks.append(DetectionBlock(in_c, channel, coord=coord_conv, norm=norm_type,
                                         conv_block_num=conv_block_num, is_first=i == 0,
                                         use_spp=spp, drop_blk=drop_block,
                                         block_size=block_size, keep_prob=keep_prob,
                                         paddle_name=f"yolo_block.{i}"))
            an = len(self.anchor_masks[i])
            nf = an * (num_classes + 6) if iou_aware else an * (num_classes + 5)
            outs.append(ConvNormAct(channel * 2, nf, 1, bias=True, act=None))
            outs[-1].paddle_name = f"yolo_output.{i}.conv"
            if i < n - 1:
                trans[str(2 * i)] = ConvNormAct(channel, 256 // (2 ** i), 1,
                                                norm=norm_type, act="leaky")
                trans[str(2 * i)].paddle_name = f"yolo_transition.{i}"
        self.detection_blocks = nn.ModuleList(blocks)
        self.yolo_output_convs = nn.ModuleList(outs)
        self.upsample_layers = nn.ModuleDict(trans)

    def param_policy(self) -> Dict[str, Any]:
        return param_policy_tree(self)

    def iter_convs(self):
        """Every ConvNormAct in the JAX ``iter_convs`` order: each block's
        layers then its tip, the output convs, the transitions."""
        return (m for m in self.modules() if isinstance(m, ConvNormAct))

    def get_outputs(self, body_feats: List[torch.Tensor],
                    generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """Top-down pathway; raw per-level maps, level 0 the coarsest.
        ``generator`` feeds DropBlock in training; the concats follow
        ``decompose_mode``."""
        feats = body_feats[::-1][: self.n_levels]
        mode = decompose_mode(self.training, feats[0].dtype)
        outputs = []
        route = None
        for i, block in enumerate(feats):
            if i > 0:
                block = [route, block] if mode == "on" else torch.cat([route, block], dim=1)
            route, tip = self.detection_blocks[i](block, generator,
                                                  decompose=mode in ("on", "inner"))
            outputs.append(self.yolo_output_convs[i](tip))
            if i < self.n_levels - 1:
                route = upsample_nearest_2x(self.upsample_layers[str(2 * i)](route))
        return outputs

    def get_prediction(self, body_feats: List[torch.Tensor],
                       im_size: torch.Tensor) -> torch.Tensor:
        """Decode + IoU-aware fuse + batched NMS -> [B, keep_top_k, 6]: the
        ``nms_type`` switch of the reference (head.py:458-468)."""
        boxes, scores = [], []
        for i, out in enumerate(self.get_outputs(body_feats)):
            lo, hi = self._mask_rows[i], self._mask_rows[i + 1]
            b, s = yolo_box_serving(
                out, self.mask_anchors_wh[lo:hi],
                self.downsample[i], self.num_classes, self.scale_x_y, im_size,
                self.clip_bbox,
                iou_aware_factor=self.iou_aware_factor if self.iou_aware else None)
            boxes.append(b)
            scores.append(s)
        if self.nms_cfg.get("nms_type", "matrix_nms") == "multiclass_nms":
            return multiclass_nms(torch.cat(boxes, dim=1), torch.cat(scores, dim=1),
                                  self.nms_cfg)
        return matrix_nms(boxes, scores, self.nms_cfg)
