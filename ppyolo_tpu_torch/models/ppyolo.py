"""PPYOLO composite model (backbone + head), eval mode.

Counterpart of ``ppyolo_tpu/models/ppyolo.py``.  Images are NCHW (any
memory format; ``channels_last`` keeps every activation physically NHWC).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.conv import ConvNormAct
from .head import YOLOv3Head
from .resnet_vd import ResNet50Vd

BACKBONES = {"Resnet50Vd": ResNet50Vd}


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

    @torch.no_grad()
    def outputs(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Raw per-level head maps [N, C_l, S_l, S_l]."""
        return self.head.get_outputs(self.backbone(images))

    @torch.no_grad()
    def predict(self, images: torch.Tensor, im_size: torch.Tensor) -> torch.Tensor:
        """images [N,3,H,W] normalized; im_size [N,2] original (h, w).
        Returns [N, keep_top_k, 6] detections on images' device."""
        return self.head.get_prediction(self.backbone(images), im_size)
