"""ResNet-vd backbones (50 and 18), NCHW in channels_last memory.

Counterpart of ``ppyolo_tpu/models/resnet_vd.py`` (``ResNet50Vd``,
``ResNet18Vd``, ``ConvBlock``, ``IdentityBlock``, ``BasicBlock``): deep 3x3
stem (fused kernel in bf16 eval, ``ops/stem.py``; the unfused chain in
training), stride inside the 3x3 (``downsample_in3x3``), avg-pool-then-1x1
projection shortcut, DCNv2 in the ``conv2`` of the stages listed in
``dcn_v2_stages``, stage freezing (``freeze_at``) and per-stage LR
multipliers (``lr_mult_list``).  Child names give the JAX param paths
(``stage2_0.conv1.conv.weight``); each conv carries the Paddle name the JAX
model gives it (``conv1_1``, ``res5a_branch2b``), which ``iter_convs``
yields in the JAX package's order for the ``.pdparams`` converter.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import avg_pool2d
from ..ops.conv import ConvNormAct, param_policy_tree
from ..ops.stem import apply_stem


class ConvBlock(nn.Module):
    """Bottleneck block with projection shortcut (reference resnet_vd.py:15-57)."""

    def __init__(self, in_c, filters, norm, lr=1.0, use_dcn=False, stride=2,
                 downsample_in3x3=True, is_first=False, freeze_norm=False, paddle_name=""):
        super().__init__()
        f1, f2, f3 = filters
        s1, s2 = (1, stride) if downsample_in3x3 else (stride, 1)
        kw = dict(norm=norm, lr_mult=lr, freeze_norm=freeze_norm)
        self.is_first = is_first
        self.conv1 = ConvNormAct(in_c, f1, 1, stride=s1, act="relu", **kw)
        self.conv2 = ConvNormAct(f1, f2, 3, stride=s2, act="relu", use_dcn=use_dcn, **kw)
        self.conv3 = ConvNormAct(f2, f3, 1, act=None, **kw)
        self.conv4 = ConvNormAct(in_c, f3, 1, stride=stride if is_first else 1, act=None,
                                 **kw)
        _paddle_names(self, paddle_name, ("conv1", "branch2a"), ("conv2", "branch2b"),
                      ("conv3", "branch2c"), ("conv4", "branch1"))

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if not self.is_first:
            x = avg_pool2d(x, 2, 2)
        return F.relu(y + self.conv4(x))


class IdentityBlock(nn.Module):
    """Bottleneck block with identity shortcut (reference resnet_vd.py:60-87)."""

    def __init__(self, in_c, filters, norm, lr=1.0, use_dcn=False, freeze_norm=False,
                 paddle_name=""):
        super().__init__()
        f1, f2, f3 = filters
        kw = dict(norm=norm, lr_mult=lr, freeze_norm=freeze_norm)
        self.conv1 = ConvNormAct(in_c, f1, 1, act="relu", **kw)
        self.conv2 = ConvNormAct(f1, f2, 3, act="relu", use_dcn=use_dcn, **kw)
        self.conv3 = ConvNormAct(f2, f3, 1, act=None, **kw)
        _paddle_names(self, paddle_name, ("conv1", "branch2a"), ("conv2", "branch2b"),
                      ("conv3", "branch2c"))

    def forward(self, x):
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + x)


class BasicBlock(nn.Module):
    """Two-conv residual block of ResNet18-vd (reference resnet_vd.py:224-267)."""

    def __init__(self, in_c, filters, norm, lr=1.0, stride=1, is_first=False,
                 use_dcn=False, freeze_norm=False, paddle_name=""):
        super().__init__()
        f1, f2 = filters
        kw = dict(norm=norm, lr_mult=lr, freeze_norm=freeze_norm)
        self.is_first = is_first
        self.has_shortcut = stride == 2 or is_first
        self.conv1 = ConvNormAct(in_c, f1, 3, stride=stride, act="relu", **kw)
        self.conv2 = ConvNormAct(f1, f2, 3, act=None, use_dcn=use_dcn, **kw)
        if self.has_shortcut:
            self.conv3 = ConvNormAct(in_c, f2, 1, stride=stride if is_first else 1,
                                     act=None, **kw)
        _paddle_names(self, paddle_name, ("conv1", "branch2a"), ("conv2", "branch2b"),
                      ("conv3", "branch1"))

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.has_shortcut:
            if not self.is_first:
                x = avg_pool2d(x, 2, 2)
            x = self.conv3(x)
        return F.relu(y + x)


def _paddle_names(block: nn.Module, prefix: str, *pairs) -> None:
    """``<prefix>_<suffix>`` as the Paddle name of each (child, suffix) the
    block has (``ppyolo_tpu/models/resnet_vd.py:100-102``)."""
    for child, suffix in pairs:
        if hasattr(block, child):
            getattr(block, child).paddle_name = f"{prefix}_{suffix}"


_STAGE_LETTERS = "abcdefghijklmnopqrstuvwxyz"


class _Backbone(nn.Module):
    """Stem, stages 2-5 in ``_stage_blocks``, freezing and the policy."""

    freeze_at: int
    feature_maps: List[int]
    _stage_blocks: Dict[int, List[str]]

    def _add_stem(self, norm, freeze_norm):
        for i, (cin, cout) in enumerate([(3, 32), (32, 32), (32, 64)], start=1):
            m = ConvNormAct(cin, cout, 3, stride=2 if i == 1 else 1, norm=norm, act="relu",
                            freeze_norm=freeze_norm)
            m.paddle_name = f"conv1_{i}"
            setattr(self, f"stage1_conv1_{i}", m)

    def iter_convs(self):
        """Every ConvNormAct, stem first, in the JAX ``iter_convs`` order."""
        return (m for m in self.modules() if isinstance(m, ConvNormAct))

    def freeze(self) -> None:
        """Stages <= freeze_at untrainable (reference resnet_vd.py:174-199):
        their BN still normalizes with batch statistics and updates its
        running stats in training, as in the JAX package."""
        if self.freeze_at >= 1:
            for i in (1, 2, 3):
                getattr(self, f"stage1_conv1_{i}").freeze()
        for s in (2, 3, 4, 5):
            if self.freeze_at >= s:
                for name in self._stage_blocks[s]:
                    for m in getattr(self, name).modules():
                        if isinstance(m, ConvNormAct):
                            m.freeze()

    def param_policy(self) -> Dict[str, Any]:
        return param_policy_tree(self)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = apply_stem([getattr(self, f"stage1_conv1_{i}") for i in (1, 2, 3)], x)
        feats = {}
        for s in (2, 3, 4, 5):
            for name in self._stage_blocks[s]:
                x = getattr(self, name)(x)
            feats[s] = x
        return [feats[s] for s in self.feature_maps]


class ResNet50Vd(_Backbone):
    """Reference Resnet50Vd (resnet_vd.py:89-220).  ``norm_decay`` is
    accepted and unused, as in the JAX package."""

    out_channels = {2: 256, 3: 512, 4: 1024, 5: 2048}

    def __init__(self, norm_type="bn", feature_maps=(3, 4, 5), dcn_v2_stages=(5,),
                 downsample_in3x3=True, freeze_at=0, freeze_norm=False,
                 norm_decay=0.0, lr_mult_list=(1.0, 1.0, 1.0, 1.0)):
        super().__init__()
        assert freeze_at in (0, 1, 2, 3, 4, 5) and len(lr_mult_list) == 4
        self.feature_maps = list(feature_maps)
        self.freeze_at = freeze_at
        self._add_stem(norm_type, freeze_norm)
        specs = [(2, 3, [64, 64, 256], 64), (3, 4, [128, 128, 512], 256),
                 (4, 6, [256, 256, 1024], 512), (5, 3, [512, 512, 2048], 1024)]
        self._stage_blocks = {}
        for stage, n, filters, in_c in specs:
            kw = dict(lr=lr_mult_list[stage - 2], use_dcn=stage in dcn_v2_stages,
                      freeze_norm=freeze_norm)
            names = []
            for b in range(n):
                name = f"stage{stage}_{b}"
                kw["paddle_name"] = f"res{stage}{_STAGE_LETTERS[b]}"
                if b == 0:
                    blk = ConvBlock(in_c, filters, norm_type,
                                    stride=1 if stage == 2 else 2,
                                    downsample_in3x3=downsample_in3x3,
                                    is_first=stage == 2, **kw)
                else:
                    blk = IdentityBlock(filters[2], filters, norm_type, **kw)
                setattr(self, name, blk)
                names.append(name)
            self._stage_blocks[stage] = names
        if freeze_at:
            self.freeze()


class ResNet18Vd(_Backbone):
    """Reference Resnet18Vd (resnet_vd.py:270-366), with DCNv2 per stage as
    the JAX package allows (the mini-2x test configuration)."""

    out_channels = {2: 64, 3: 128, 4: 256, 5: 512}

    def __init__(self, norm_type="bn", feature_maps=(4, 5), dcn_v2_stages=(),
                 freeze_at=0, freeze_norm=False, norm_decay=0.0,
                 lr_mult_list=(1.0, 1.0, 1.0, 1.0)):
        super().__init__()
        assert freeze_at in (0, 1, 2, 3, 4, 5)
        self.feature_maps = list(feature_maps)
        self.freeze_at = freeze_at
        self._add_stem(norm_type, freeze_norm)
        specs = [(2, [64, 64], 64, 1), (3, [128, 128], 64, 2),
                 (4, [256, 256], 128, 2), (5, [512, 512], 256, 2)]
        self._stage_blocks = {}
        for stage, filters, in_c, stride in specs:
            for b in range(2):
                setattr(self, f"stage{stage}_{b}", BasicBlock(
                    in_c if b == 0 else filters[1], filters, norm_type,
                    lr=lr_mult_list[stage - 2], stride=stride if b == 0 else 1,
                    is_first=stage == 2 and b == 0, use_dcn=stage in dcn_v2_stages,
                    freeze_norm=freeze_norm, paddle_name=f"res{stage}{_STAGE_LETTERS[b]}"))
            self._stage_blocks[stage] = [f"stage{stage}_0", f"stage{stage}_1"]
        if freeze_at:
            self.freeze()
