"""Tree helpers, the device rule, the optimizer policy and BatchNorm.

The port's ``state_dict`` keys are the JAX package's param-tree dotted
paths exactly (``backbone.stage2_0.conv1.conv.weight``,
``head.detection_blocks.0.tip_layers.1.bn.running_var``), so a JAX param
tree converts by transposing the conv kernels and nothing else
(``checkpoint/bridge.py``).  Module attribute names are chosen to produce
those paths; ``BatchNorm`` registers no ``num_batches_tracked``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: running = (1-m)*running + m*batch


@dataclasses.dataclass(frozen=True)
class ParamPolicy:
    """Optimizer policy of one leaf (``ppyolo_tpu/ops/module.py::ParamPolicy``,
    reference custom_layers.py:167-241)."""

    lr_mult: float = 1.0
    wd_mult: float = 1.0
    trainable: bool = True


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {dotted_path: leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, p))
        else:
            out[p] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{dotted_path: leaf} -> nested dict."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        segs = path.split(".")
        for seg in segs[:-1]:
            node = node.setdefault(seg, {})
        node[segs[-1]] = v
    return tree


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  Raises when CUDA is asked for (or defaulted to)
    and there is no card -- it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


class BatchNorm(nn.Module):
    """BatchNorm over NCHW (``ppyolo_tpu/ops/conv.py::batch_norm``).

    Train mode (``self.training``) normalizes with fp32 batch statistics of
    ``x.float()``, ``var = max(E[x^2] - E[x]^2, 0)``, and updates the
    running stats in place with the torch convention (unbiased var,
    momentum 0.1).  A frozen layer does the same: freezing stops gradients
    only (``conv.py:305-308``).

    Eval mode is one fused pass, ``x * k + b`` with ``k = weight *
    rsqrt(var + eps)`` and ``b = bias - mean * k`` computed on the [C]
    vectors in fp32 (fp64 for an fp64 input).  The JAX package evaluates
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` op by op; in eager
    PyTorch that order costs four passes over the activation instead of
    one, and the results differ only in rounding.  (k, b) are cached until
    a parameter or buffer changes (new storage, in-place write, dtype)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._affine_key = None
        self._affine = None

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward_train(x)
        ts = (self.weight, self.bias, self.running_mean, self.running_var)
        key = (x.dtype,) + tuple((t.data_ptr(), t._version) for t in ts)
        if key != self._affine_key:
            acc = torch.promote_types(x.dtype, torch.float32)
            with torch.no_grad():
                k = self.weight.to(acc) * torch.rsqrt(self.running_var.to(acc) + BN_EPS)
                b = self.bias.to(acc) - self.running_mean.to(acc) * k
            shape = (1, -1, 1, 1)
            self._affine = (k.to(x.dtype).view(shape), b.to(x.dtype).view(shape))
            self._affine_key = key
        k, b = self._affine
        return torch.addcmul(b, x, k)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(acc)
        dims = (0, 2, 3)
        m = x32.mean(dims)
        msq = x32.square().mean(dims)
        v = torch.maximum(msq - m.square(), torch.zeros_like(m))  # JAX's tie rule
        # (x - m) * (rsqrt(v + eps) * weight) + bias: the JAX expression with
        # the two [C] factors multiplied first, so autograd keeps one
        # full-size fp32 tensor (x - m) instead of three
        shape = (1, -1, 1, 1)
        k = torch.rsqrt(v + BN_EPS) * self.weight
        y = torch.addcmul(self.bias.view(shape).to(acc), x32 - m.view(shape),
                          k.view(shape))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            unbiased = v * (n / max(n - 1, 1))
            for buf, stat in ((self.running_mean, m), (self.running_var, unbiased)):
                buf.copy_((1 - BN_MOMENTUM) * buf + BN_MOMENTUM * stat.to(buf.dtype))
        return y.to(x.dtype)
