"""Tree helpers, the device rule and eval-mode BatchNorm for the port.

The port's ``state_dict`` keys are the JAX package's param-tree dotted
paths exactly (``backbone.stage2_0.conv1.conv.weight``,
``head.detection_blocks.0.tip_layers.1.bn.running_var``), so a JAX param
tree converts by transposing the conv kernels and nothing else
(``checkpoint/bridge.py``).  Module attribute names are chosen to produce
those paths; ``BatchNorm`` registers no ``num_batches_tracked``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

BN_EPS = 1e-5


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
    """Eval-mode BatchNorm over NCHW as one fused pass, ``x * k + b`` with
    ``k = weight * rsqrt(var + eps)`` and ``b = bias - mean * k`` computed
    on the [C] vectors in fp32 (fp64 for an fp64 input).  The JAX package's ``batch_norm``
    (train=False) evaluates ``(x - mean) * rsqrt(var + eps) * weight +
    bias`` op by op; in eager PyTorch that order costs four passes over the
    activation instead of one, and the results differ only in rounding.
    (k, b) are cached until a parameter or buffer changes (new storage,
    in-place write, dtype).  Training-mode statistics belong to the
    training slice."""

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
