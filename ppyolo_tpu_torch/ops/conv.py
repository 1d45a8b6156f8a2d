"""ConvNormAct: conv or DCNv2, then BN, then the activation.

Counterpart of ``ppyolo_tpu/ops/conv.py::ConvNormAct``, with its optimizer
policy (``param_policy``) and freeze flag.  Parameter names give the JAX
param tree's paths:
``conv.weight`` / ``conv.bias`` for a dense conv, ``conv.dcn_weight`` and
``conv.conv_offset.{weight,bias}`` for DCNv2, ``bn.{weight,bias,
running_mean,running_var}`` for BN; ``norm="sync_bn"`` averages the batch
statistics over the ranks of a process group (``ops/module.py::BatchNorm``).  Weights are OIHW; activations NCHW in
``channels_last`` memory.  Dense convs go to ``F.conv2d`` (cuDNN on the
card), as the JAX package leaves them to XLA; DCNv2 goes to
``ops/deform_conv.py::deform_conv2d`` (the Hopper kernels on the card,
forward and backward).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .deform_conv import deform_conv2d, needs_grad
from .module import BatchNorm, ParamPolicy, flatten_tree, store_cached, unflatten_tree


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
    """conv (or DCNv2) + {bn|none} + {relu|leaky|none}.  ``frozen`` (set by
    ``freeze``) and ``freeze_norm`` take leaves out of training: their
    ``requires_grad`` follows ``param_policy``."""

    def __init__(self, cin: int, cout: int, ksize: int, *, stride: int = 1,
                 bias: bool = False, norm: Optional[str] = None,
                 act: Optional[str] = None, use_dcn: bool = False,
                 lr_mult: float = 1.0, bias_lr_mult: Optional[float] = None,
                 freeze_norm: bool = False):
        super().__init__()
        if norm not in (None, "bn", "sync_bn"):
            raise NotImplementedError(f"norm '{norm}' is not ported yet")
        self.cin, self.cout, self.ksize, self.stride = cin, cout, ksize, stride
        self.padding = (ksize - 1) // 2
        self.norm, self.act, self.use_dcn = norm, act, use_dcn
        self.has_bias = bias and not use_dcn
        self.lr_mult = lr_mult
        self.bias_lr_mult = lr_mult if bias_lr_mult is None else bias_lr_mult
        self.freeze_norm = freeze_norm
        self.conv = _ConvParams(cin, cout, ksize, bias, use_dcn)
        self.bn = BatchNorm(cout, sync=norm == "sync_bn") if norm is not None else None
        self._packed = None
        self._packed_key = None
        self.freeze(False)

    def freeze(self, flag: bool = True) -> None:
        """Mark the layer untrainable (or trainable again) and set every
        parameter's ``requires_grad`` from the policy."""
        self.frozen = flag
        params = dict(self.named_parameters())
        for path, pol in flatten_tree(self.param_policy()).items():
            if path in params:
                params[path].requires_grad_(pol.trainable)

    def param_policy(self) -> Dict[str, Any]:
        """Per-leaf policy tree exactly as ``ppyolo_tpu/ops/conv.py:384-418``:
        lr_mult everywhere, no weight decay for BN params and the conv bias,
        BN running stats never trained."""
        t = not self.frozen
        pol: Dict[str, Any] = {"conv": {}}
        if self.use_dcn:
            pol["conv"]["conv_offset"] = {"weight": ParamPolicy(self.lr_mult, 1.0, t),
                                          "bias": ParamPolicy(self.lr_mult, 1.0, t)}
            pol["conv"]["dcn_weight"] = ParamPolicy(self.lr_mult, 1.0, t)
        else:
            pol["conv"]["weight"] = ParamPolicy(self.lr_mult, 1.0, t)
            if self.has_bias:
                pol["conv"]["bias"] = ParamPolicy(self.bias_lr_mult, 0.0, t)
        if self.bn is not None:
            tn = t and not self.freeze_norm
            pol["bn"] = {"weight": ParamPolicy(self.lr_mult, 0.0, tn),
                         "bias": ParamPolicy(self.lr_mult, 0.0, tn),
                         "running_mean": ParamPolicy(0.0, 0.0, False),
                         "running_var": ParamPolicy(0.0, 0.0, False)}
        return pol

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
            old = None if self._packed is None else (self._packed,)
            self._packed = store_cached(old, (pack_dcn_weight(w.detach()),))[0]
            self._packed_key = key
        return self._packed

    def refresh_cache(self) -> None:
        """Re-pack the cached DCN weight, and the folded stem when this is
        the module that holds it, into their existing tensors."""
        if self._packed is not None:
            self.packed_dcn_weight()
        stem = getattr(self, "_stem_cache", None)
        if stem is not None:
            from .stem import stem_params

            stem_params(stem[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.use_dcn:
            om = F.conv2d(x, c.conv_offset.weight, c.conv_offset.bias,
                          self.stride, self.padding)
            # the cached packed weight has no gradient: serving only
            packed = (self.packed_dcn_weight()
                      if x.is_cuda and not needs_grad(x, c.dcn_weight, om) else None)
            x = deform_conv2d(x, c.dcn_weight, om, stride=self.stride,
                              padding=self.padding, packed_weight=packed)
        else:
            x = F.conv2d(x, c.weight, c.bias, self.stride, self.padding)
        if self.bn is not None:
            x = self.bn(x)
        return apply_act(x, self.act)


def param_policy_tree(module: nn.Module) -> Dict[str, Any]:
    """The policy tree of every ConvNormAct under ``module``, keyed by the
    param paths relative to it (the JAX ``param_policy`` tree)."""
    flat = {}
    for name, m in module.named_modules():
        if isinstance(m, ConvNormAct):
            for k, pol in flatten_tree(m.param_policy()).items():
                flat[f"{name}.{k}" if name else k] = pol
    return unflatten_tree(flat)
