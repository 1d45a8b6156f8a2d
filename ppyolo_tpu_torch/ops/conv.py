"""ConvNormAct: conv or DCNv2, then eval-mode BN, then the activation.

Counterpart of ``ppyolo_tpu/ops/conv.py::ConvNormAct`` for the serving
path.  Parameter names give the JAX param tree's paths:
``conv.weight`` / ``conv.bias`` for a dense conv, ``conv.dcn_weight`` and
``conv.conv_offset.{weight,bias}`` for DCNv2, ``bn.{weight,bias,
running_mean,running_var}`` for BN.  Weights are OIHW; activations NCHW in
``channels_last`` memory.  Dense convs go to ``F.conv2d`` (cuDNN on the
card), as the JAX package leaves them to XLA; DCNv2 goes to
``ops/deform_conv.py::deform_conv2d`` (the Hopper kernel on the card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .deform_conv import deform_conv2d
from .module import BatchNorm


def apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    raise NotImplementedError(f"Activation '{act}' is not implemented.")


class _ConvParams(nn.Module):
    """The ``conv`` node of the param tree (parameters only)."""

    def __init__(self, cin: int, cout: int, ksize: int, bias: bool, use_dcn: bool):
        super().__init__()
        w = torch.zeros(cout, cin, ksize, ksize)
        if use_dcn:
            k2 = ksize * ksize
            self.conv_offset = nn.Conv2d(cin, 3 * k2, ksize)  # weight + bias holder
            self.dcn_weight = nn.Parameter(w)
        else:
            self.weight = nn.Parameter(w)
            self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class ConvNormAct(nn.Module):
    """conv (or DCNv2) + {bn|none} + {relu|leaky|none}, eval mode."""

    def __init__(self, cin: int, cout: int, ksize: int, *, stride: int = 1,
                 bias: bool = False, norm: Optional[str] = None,
                 act: Optional[str] = None, use_dcn: bool = False):
        super().__init__()
        if norm not in (None, "bn", "sync_bn"):
            raise NotImplementedError(f"norm '{norm}' is not ported yet")
        self.cin, self.cout, self.ksize, self.stride = cin, cout, ksize, stride
        self.padding = (ksize - 1) // 2
        self.norm, self.act, self.use_dcn = norm, act, use_dcn
        self.conv = _ConvParams(cin, cout, ksize, bias, use_dcn)
        self.bn = BatchNorm(cout) if norm is not None else None
        self._packed = None
        self._packed_key = None

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions: kaiming-normal conv weight,
        xavier-normal ``dcn_weight``, zero offset conv and biases, identity
        BN."""
        k = self.ksize
        fan_in = self.cin * k * k
        c = self.conv
        if self.use_dcn:
            c.conv_offset.weight.zero_()
            c.conv_offset.bias.zero_()
            std = math.sqrt(2.0 / (fan_in + self.cout * k * k))
            c.dcn_weight.copy_(torch.randn(c.dcn_weight.shape, generator=generator) * std)
        else:
            std = math.sqrt(2.0 / fan_in)
            c.weight.copy_(torch.randn(c.weight.shape, generator=generator) * std)
            if c.bias is not None:
                c.bias.zero_()
        if self.bn is not None:
            self.bn.reset_parameters()

    def packed_dcn_weight(self) -> torch.Tensor:
        """``dcn_weight`` packed for the kernel, recomputed only when the
        weight changes (a new tensor, an in-place write, a dtype move)."""
        from .deform_conv_cuda import pack_dcn_weight

        w = self.conv.dcn_weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if key != self._packed_key:
            self._packed = pack_dcn_weight(w.detach())
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.use_dcn:
            om = F.conv2d(x, c.conv_offset.weight, c.conv_offset.bias,
                          self.stride, self.padding)
            packed = self.packed_dcn_weight() if x.is_cuda else None
            x = deform_conv2d(x, c.dcn_weight, om, stride=self.stride,
                              padding=self.padding, packed_weight=packed)
        else:
            x = F.conv2d(x, c.weight, c.bias, self.stride, self.padding)
        if self.bn is not None:
            x = self.bn(x)
        return apply_act(x, self.act)
