"""PPYOLO composite model (backbone + head).

Counterpart of ``ppyolo_tpu/models/ppyolo.py``.  Images are NCHW (any
memory format; ``channels_last`` keeps every activation physically NHWC).
``forward`` is the training forward (the JAX ``outputs``, with gradients);
``outputs`` and ``predict`` serve without them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..ops.conv import ConvNormAct, param_policy_tree
from ..ops.module import checkpointed, flatten_tree
from .head import YOLOv3Head
from .resnet_vd import ResNet18Vd, ResNet50Vd

BACKBONES = {"Resnet50Vd": ResNet50Vd, "Resnet18Vd": ResNet18Vd}


class PPYOLO(nn.Module):
    def __init__(self, backbone: nn.Module, head: YOLOv3Head):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @classmethod
    def from_config(cls, cfg) -> "PPYOLO":
        if cfg.backbone_type not in BACKBONES:
            raise NotImplementedError(
                f"backbone {cfg.backbone_type} is not ported yet")
        bb = BACKBONES[cfg.backbone_type](**cfg.backbone)
        head = YOLOv3Head(**cfg.head, nms_cfg=cfg.nms_cfg)
        return cls(bb, head).eval()

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> "PPYOLO":
        """Random init with the JAX init's distributions (not its numbers:
        torch and JAX generators differ), drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, ConvNormAct):
                m.init_parameters(generator)
        return self

    def param_policy(self) -> Dict[str, Any]:
        return param_policy_tree(self)

    def flat_policy(self) -> Dict[str, Any]:
        """{state_dict key: ParamPolicy}, the JAX ``flat_policy``."""
        return flatten_tree(self.param_policy())

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                remat: bool = False) -> List[torch.Tensor]:
        """Raw per-level head maps [N, C_l, S_l, S_l] with gradients (the
        JAX ``outputs``, ``ppyolo.py:66-69``); in train mode BN uses batch
        statistics and DropBlock draws from ``generator``.  ``remat``
        recomputes the backbone's activations in the backward instead of
        keeping them (``train_step.py:120-132``)."""
        feats = checkpointed(self.backbone, images) if remat else self.backbone(images)
        return self.head.get_outputs(list(feats), generator)

    @torch.no_grad()
    def outputs(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Raw per-level head maps [N, C_l, S_l, S_l]."""
        return self.head.get_outputs(self.backbone(images))

    @torch.no_grad()
    def predict(self, images: torch.Tensor, im_size: torch.Tensor) -> torch.Tensor:
        """images [N,3,H,W] normalized; im_size [N,2] original (h, w).
        Returns [N, keep_top_k, 6] detections on images' device."""
        return self.head.get_prediction(self.backbone(images), im_size)
