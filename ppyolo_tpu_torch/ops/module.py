"""Tree helpers, the device rule, the optimizer policy, mode overrides and
the norms: BatchNorm, GroupNorm and AffineChannel.

The port's ``state_dict`` keys are the JAX package's param-tree dotted
paths exactly (``backbone.stage2_0.conv1.conv.weight``,
``head.detection_blocks.0.tip_layers.1.bn.running_var``), so a JAX param
tree converts by transposing the conv kernels and nothing else
(``checkpoint/bridge.py``).  Module attribute names are chosen to produce
those paths; ``BatchNorm`` registers no ``num_batches_tracked``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed.nn.functional as dist_fn
from torch import nn

from ..parallel import dist
from .bn_train import bn_train

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


def make_contextvar_override(name: str, allowed: tuple, default: str):
    """A (ContextVar, context manager) pair for a mode read while a forward
    is traced or captured (``ppyolo_tpu/ops/module.py:134``): a ContextVar,
    not a module global, so another thread's override is never seen
    mid-forward.  The head's virtual-concat mode uses it
    (``models/head.py::head_decompose``)."""
    import contextvars

    var = contextvars.ContextVar(name, default=default)

    class _override:
        def __init__(self, value: str):
            if value not in allowed:
                raise ValueError(f"{name}: {value!r} is not one of {allowed}")
            self.value = value

        def __enter__(self):
            self._token = var.set(self.value)
            return self

        def __exit__(self, *exc):
            var.reset(self._token)
            return False

    _override.__name__ = _override.__qualname__ = name.lower() + "_override"
    return var, _override


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept, so the op that reads it copies
    nothing from the host and a CUDA graph can capture it.  While
    torch.export traces, a constant of the program (never kept: it would
    be the trace's fake tensor)."""
    arr = np.asarray(values)
    if torch.compiler.is_exporting():
        return torch.tensor(arr, dtype=dtype, device=device)
    key = (arr.shape, str(arr.dtype), arr.tobytes(), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(arr, dtype=dtype, device=device)
    return t


def store_cached(old: Optional[Sequence[torch.Tensor]],
                 new: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """A cache's new values, written into its old tensors where every shape,
    dtype and device agrees (so a CUDA graph that captured a read of the
    old tensors reads the new values), else the new tensors."""
    if old is not None and len(old) == len(new) and all(
            o.shape == n.shape and o.dtype == n.dtype and o.device == n.device
            for o, n in zip(old, new)):
        with torch.no_grad():
            for o, n in zip(old, new):
                o.copy_(n)
        return old
    return new


def refresh_caches(model: nn.Module) -> None:
    """Recompute every cache of ``model`` derived from its parameters (BN's
    eval affine, the DCN's packed weight, the folded and packed stem) into
    its existing tensors, where they are stale.  A CUDA graph's replay reads
    the caches without checking them, so ``train/graphs.py`` calls this
    before a replay when a parameter or buffer was written since the last."""
    for m in model.modules():
        if m is not model and hasattr(m, "refresh_cache"):
            m.refresh_cache()


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else, and under a process group ``cuda:LOCAL_RANK`` for
    a cuda device without an index.  Raises when CUDA is asked for (or
    defaulted to) and there is no card -- it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None and dist.active():
        dev = torch.device("cuda", dist.local_rank())
    return dev


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    """Marks the thread as rerunning a checkpointed forward."""
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def checkpointed(module: nn.Module, x: torch.Tensor) -> tuple:
    """``tuple(module(x))`` whose activations are recomputed in the backward
    instead of kept (``jax.checkpoint``; ``torch.utils.checkpoint``,
    non-reentrant).  The module's parameters enter as explicit inputs, so
    the recompute, which runs after a ``functional_call`` around the
    forward has put the masters back, uses the tensors the forward used
    (the bf16 copies of a mixed-precision step).  While recomputing, BN
    does not update its running statistics again: one momentum update a
    step, as without the checkpoint.  ``module`` draws no random numbers,
    so no generator state is kept."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    names, values = zip(*module.named_parameters())

    def run(inp, *params):
        return tuple(functional_call(module, dict(zip(names, params)), (inp,)))

    return checkpoint(run, x, *values, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class BatchNorm(nn.Module):
    """BatchNorm over NCHW (``ppyolo_tpu/ops/conv.py::batch_norm``).

    Train mode (``self.training``) normalizes with fp32 batch statistics of
    ``x.float()``, ``var = max(E[x^2] - E[x]^2, 0)``, and updates the
    running stats in place with the torch convention (unbiased var,
    momentum 0.1).  A frozen layer does the same: freezing stops gradients
    only (``conv.py:305-308``).  With ``sync`` (``norm="sync_bn"``) and a
    process group, ``E[x]`` and ``E[x^2]`` are averaged over the ranks by
    one differentiable all-reduce of a ``[2C]`` tensor (its backward is an
    all-reduce too: ``conv.py:138-148``'s pmean) and the unbiased factor
    counts ``n × world`` values; this holds at world 1 as well.  Without
    ``sync`` each rank keeps statistics of its own batch, as each JAX
    replica does under ``norm="bn"``.

    On a CUDA tensor train mode runs K7 instead (``ops/bn_train.py``): the
    same statistics, clamp, running update and sync from a statistics pass
    and one normalize + affine + activation pass forward, two passes
    backward.  ``act`` (None, "relu" or "leaky") is that path's fused
    activation; on any other path the caller applies its activation.

    Eval mode is one fused pass, ``x * k + b`` with ``k = weight *
    rsqrt(var + eps)`` and ``b = bias - mean * k`` computed on the [C]
    vectors in fp32 (fp64 for an fp64 input).  The JAX package evaluates
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` op by op; in eager
    PyTorch that order costs four passes over the activation instead of
    one, and the results differ only in rounding.  (k, b) are cached until
    a parameter or buffer changes (new storage, in-place write, dtype)."""

    def __init__(self, channels: int, sync: bool = False):
        super().__init__()
        self.sync = sync
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

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        if self.training and x.is_cuda:
            return bn_train(x, self.weight, self.bias, self.running_mean, self.running_var,
                            act=act, update=not getattr(_RECOMPUTE, "on", False),
                            sync=self.sync and dist.active(), eps=BN_EPS, momentum=BN_MOMENTUM)
        if act is not None:
            raise ValueError("BatchNorm applies an activation only on its train kernels' "
                             "path (a CUDA tensor in training)")
        if self.training:
            return self._forward_train(x)
        k, b = self.eval_affine(x.dtype)
        return torch.addcmul(b, x, k)

    def eval_affine(self, dtype: torch.dtype):
        """(k, b) of the eval pass in ``dtype``, each [1, C, 1, 1]; computed
        in the program, not cached, while torch.export traces it (under the
        caller's ``no_grad``: a grad-mode switch per layer makes the export
        slow)."""
        if torch.compiler.is_exporting():
            return self._affine_of(dtype)
        ts = (self.weight, self.bias, self.running_mean, self.running_var)
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in ts)
        if key != self._affine_key:
            with torch.no_grad():
                self._affine = store_cached(self._affine, self._affine_of(dtype))
            self._affine_key = key
        return self._affine

    def _affine_of(self, dtype: torch.dtype):
        acc = torch.promote_types(dtype, torch.float32)
        k = self.weight.to(acc) * torch.rsqrt(self.running_var.to(acc) + BN_EPS)
        b = self.bias.to(acc) - self.running_mean.to(acc) * k
        shape = (1, -1, 1, 1)
        return k.to(dtype).view(shape), b.to(dtype).view(shape)

    def refresh_cache(self) -> None:
        if self._affine is not None:
            self.eval_affine(self._affine[0].dtype)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(acc)
        dims = (0, 2, 3)
        m = x32.mean(dims)
        msq = x32.square().mean(dims)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        if self.sync and dist.active():
            stats = dist_fn.all_reduce(torch.cat([m, msq])) / dist.world()
            m, msq = stats.split(m.shape[0])
            n *= dist.world()
        v = torch.maximum(msq - m.square(), torch.zeros_like(m))  # JAX's tie rule
        # (x - m) * (rsqrt(v + eps) * weight) + bias: the JAX expression with
        # the two [C] factors multiplied first, so autograd keeps one
        # full-size fp32 tensor (x - m) instead of three
        shape = (1, -1, 1, 1)
        k = torch.rsqrt(v + BN_EPS) * self.weight
        y = torch.addcmul(self.bias.view(shape).to(acc), x32 - m.view(shape),
                          k.view(shape))
        if getattr(_RECOMPUTE, "on", False):   # the forward already updated them
            return y.to(x.dtype)
        with torch.no_grad():
            unbiased = v * (n / max(n - 1, 1))
            for buf, stat in ((self.running_mean, m), (self.running_var, unbiased)):
                buf.copy_((1 - BN_MOMENTUM) * buf + BN_MOMENTUM * stat.to(buf.dtype))
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW (``ppyolo_tpu/ops/conv.py::group_norm``): the
    channels split into ``groups`` groups of ``C / groups``; each image's
    group is normalized by its mean and biased variance over (its channels,
    H, W), ``(g - m) * rsqrt(v + eps)``, then ``* weight + bias`` per
    channel and a cast back to x's dtype.  The statistics are fp32 for bf16
    and fp32 input (JAX's ``astype(float32)``) and fp64 for fp64 input.

    The group view of a ``channels_last`` tensor splits its unit-stride
    channel dimension, so it is a view (no copy).  The normalization and
    the affine fold into one ``x * k + b`` pass with ``k = rsqrt(v + eps) *
    weight`` and ``b = bias - m * k`` per (image, channel), formed in the
    statistics' dtype: the passes over the activation are the cast to the
    statistics' dtype (none for fp32 and fp64), ``var_mean`` and the fused
    affine.  No running statistics: eval and training are the same
    function, and nothing is synced across ranks."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"GroupNorm: {channels} channels do not split into {groups} groups")
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = self.groups
        acc = torch.promote_types(x.dtype, torch.float32)
        xa = x.to(acc)
        v, m = torch.var_mean(xa.view(n, g, c // g, h, w), dim=(2, 3, 4), correction=0)
        inv = torch.rsqrt(v + BN_EPS).repeat_interleave(c // g, dim=1)          # [n, c]
        k = inv * self.weight.to(acc)
        b = self.bias.to(acc) - m.repeat_interleave(c // g, dim=1) * k
        return torch.addcmul(b.view(n, c, 1, 1), xa, k.view(n, c, 1, 1)).to(x.dtype)


class AffineChannel(nn.Module):
    """``x * weight + bias`` per channel (``ppyolo_tpu/ops/conv.py``'s
    ``affine_channel``, reference custom_layers.py:46-62), in the dtype the
    two operands promote to, as in JAX."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return x * self.weight.view(shape) + self.bias.view(shape)
