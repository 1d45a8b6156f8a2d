"""ResNet50-vd backbone, eval mode, NCHW in channels_last memory.

Counterpart of ``ppyolo_tpu/models/resnet_vd.py`` (``ResNet50Vd``,
``ConvBlock``, ``IdentityBlock``): deep 3x3 stem (fused kernel where
eligible, ``ops/stem.py``), stride inside the 3x3 (``downsample_in3x3``),
avg-pool-then-1x1 projection shortcut, DCNv2 in the ``conv2`` of the
stages listed in ``dcn_v2_stages``.  Child names give the JAX param paths
(``stage2_0.conv1.conv.weight``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import avg_pool2d
from ..ops.conv import ConvNormAct
from ..ops.stem import apply_stem


class ConvBlock(nn.Module):
    """Bottleneck block with projection shortcut (reference resnet_vd.py:15-57)."""

    def __init__(self, in_c, filters, norm, use_dcn=False, stride=2,
                 downsample_in3x3=True, is_first=False):
        super().__init__()
        f1, f2, f3 = filters
        s1, s2 = (1, stride) if downsample_in3x3 else (stride, 1)
        self.is_first = is_first
        self.conv1 = ConvNormAct(in_c, f1, 1, stride=s1, norm=norm, act="relu")
        self.conv2 = ConvNormAct(f1, f2, 3, stride=s2, norm=norm, act="relu",
                                 use_dcn=use_dcn)
        self.conv3 = ConvNormAct(f2, f3, 1, norm=norm, act=None)
        self.conv4 = ConvNormAct(in_c, f3, 1, stride=stride if is_first else 1,
                                 norm=norm, act=None)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if not self.is_first:
            x = avg_pool2d(x, 2, 2)
        return F.relu(y + self.conv4(x))


class IdentityBlock(nn.Module):
    """Bottleneck block with identity shortcut (reference resnet_vd.py:60-87)."""

    def __init__(self, in_c, filters, norm, use_dcn=False):
        super().__init__()
        f1, f2, f3 = filters
        self.conv1 = ConvNormAct(in_c, f1, 1, norm=norm, act="relu")
        self.conv2 = ConvNormAct(f1, f2, 3, norm=norm, act="relu", use_dcn=use_dcn)
        self.conv3 = ConvNormAct(f2, f3, 1, norm=norm, act=None)

    def forward(self, x):
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + x)


class ResNet50Vd(nn.Module):
    """Reference Resnet50Vd (resnet_vd.py:89-220), eval mode.

    Training-only options of the JAX config (``freeze_at``, ``freeze_norm``,
    ``norm_decay``, ``lr_mult_list``) are accepted and have no effect on
    the forward."""

    out_channels = {2: 256, 3: 512, 4: 1024, 5: 2048}

    def __init__(self, norm_type="bn", feature_maps=(3, 4, 5), dcn_v2_stages=(5,),
                 downsample_in3x3=True, freeze_at=0, freeze_norm=False,
                 norm_decay=0.0, lr_mult_list=(1.0, 1.0, 1.0, 1.0)):
        super().__init__()
        self.feature_maps = list(feature_maps)
        for i, (cin, cout) in enumerate([(3, 32), (32, 32), (32, 64)], start=1):
            setattr(self, f"stage1_conv1_{i}",
                    ConvNormAct(cin, cout, 3, stride=2 if i == 1 else 1,
                                norm=norm_type, act="relu"))
        specs = [(2, 3, [64, 64, 256], 64), (3, 4, [128, 128, 512], 256),
                 (4, 6, [256, 256, 1024], 512), (5, 3, [512, 512, 2048], 1024)]
        self._stage_blocks = {}
        for stage, n, filters, in_c in specs:
            use_dcn = stage in dcn_v2_stages
            names = []
            for b in range(n):
                name = f"stage{stage}_{b}"
                if b == 0:
                    blk = ConvBlock(in_c, filters, norm_type, use_dcn=use_dcn,
                                    stride=1 if stage == 2 else 2,
                                    downsample_in3x3=downsample_in3x3,
                                    is_first=stage == 2)
                else:
                    blk = IdentityBlock(filters[2], filters, norm_type, use_dcn=use_dcn)
                setattr(self, name, blk)
                names.append(name)
            self._stage_blocks[stage] = names

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = apply_stem([getattr(self, f"stage1_conv1_{i}") for i in (1, 2, 3)], x)
        feats = {}
        for s in (2, 3, 4, 5):
            for name in self._stage_blocks[s]:
                x = getattr(self, name)(x)
            feats[s] = x
        return [feats[s] for s in self.feature_maps]
