"""ConvNormAct: conv or DCNv2, then the norm, then the activation.

Counterpart of ``ppyolo_tpu/ops/conv.py::ConvNormAct``, with its optimizer
policy (``param_policy``) and freeze flag.  Parameter names give the JAX
param tree's paths:
``conv.weight`` / ``conv.bias`` for a dense conv, ``conv.dcn_weight`` and
``conv.conv_offset.{weight,bias}`` for DCNv2, ``bn.{weight,bias,
running_mean,running_var}`` for BN, ``gn.{weight,bias}`` for GroupNorm (32
groups by default) and ``af.{weight,bias}`` for affine_channel;
``norm="sync_bn"`` averages the batch statistics over the ranks of a
process group (``ops/module.py::BatchNorm``).  The activations are relu,
leaky (0.1) and mish.
Weights are OIHW; activations NCHW in ``channels_last`` memory.  Dense
convs go to ``F.conv2d`` (cuDNN on the card), as the JAX package leaves
them to XLA; DCNv2 goes to ``ops/deform_conv.py::deform_conv2d`` (the
Hopper kernels on the card, forward and backward).

The int8 serving form (``ppyolo_tpu/ops/conv.py:278-288``): ``conv.weight``
int8 OIHW, ``conv.weight_scale`` [O] fp32 and, once calibrated,
``conv.act_scale`` 0-d fp32, all buffers; ``forward`` dispatches on the
weight's dtype to ``ops/conv_int8.py::quantized_conv2d`` (K5 on the card).
``match_int8_form`` gives a model the form of a state dict, so that
``load_state_dict`` takes an int8 tree.  The scales stay fp32 through
``Module.to(dtype)``, as ``keep_fp32_suffixes`` keeps them in JAX.  Under
``recording()`` every non-DCN conv puts its input's fp32 abs-max under
itself (the JAX ``Ctx.record``, ``ops/conv.py:245-247``), for the int8
calibration.

``forward_parts`` runs the conv over a virtual channel concat (the head's
``HEAD_DECOMPOSE`` modes, ``ppyolo_tpu/ops/conv.py:328-383``), and
``paddle_name`` is the layer's name in a Paddle ``.pdparams`` file, set by
the models as the JAX package sets it (``checkpoint/convert.py``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .bn_train import ACTS as BN_TRAIN_ACTS
from .conv_int8 import dynamic_act_scale, pack_int8_weight, quantized_conv2d
from .deform_conv import deform_conv2d, needs_grad
from .module import (AffineChannel, BatchNorm, GroupNorm, ParamPolicy, flatten_tree,
                     store_cached, unflatten_tree)

NORMS = (None, "bn", "sync_bn", "gn", "affine_channel")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)`` op by op:
    ``max(x, 0) + log1p(exp(-|x|))``.  (``F.softplus`` returns x itself
    past its threshold of 20; this form never switches.)"""
    return F.relu(x) + torch.log1p(torch.exp(-x.abs()))


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` (``ppyolo_tpu/ops/conv.py::mish``)."""
    return x * torch.tanh(softplus(x))


def apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act == "mish":
        return mish(x)
    raise NotImplementedError(f"Activation '{act}' is not implemented.")


_RECORD = threading.local()


@contextlib.contextmanager
def recording():
    """Yields a dict that every non-DCN ConvNormAct run inside the block
    fills with ``{module: amax(|f32(x)|)}`` of its input (a 0-d tensor on
    the input's device; the last call of a module wins)."""
    before = getattr(_RECORD, "rec", None)
    _RECORD.rec = rec = {}
    try:
        yield rec
    finally:
        _RECORD.rec = before


SCALE_NAMES = ("weight_scale", "act_scale")   # int8 form leaves kept fp32


class _ConvParams(nn.Module):
    """The ``conv`` node of the param tree (parameters, and the int8 form's
    buffers)."""

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

    @property
    def is_int8(self) -> bool:
        return "weight" in self._buffers

    def to_int8(self, act_scale: bool) -> None:
        """Take the int8 form (zeros until loaded) on the weight's device:
        ``weight`` int8, ``weight_scale`` [O] fp32, and ``act_scale`` 0-d
        fp32 only when ``act_scale``."""
        w = self.weight
        if not self.is_int8:
            del self.weight
            self.register_buffer("weight", torch.zeros(w.shape, dtype=torch.int8,
                                                       device=w.device))
            self.register_buffer("weight_scale", torch.zeros(w.shape[0], dtype=torch.float32,
                                                             device=w.device))
        if act_scale and "act_scale" not in self._buffers:
            self.register_buffer("act_scale", torch.zeros((), dtype=torch.float32,
                                                          device=w.device))
        elif not act_scale:
            self._buffers.pop("act_scale", None)

    def to_float(self, dtype: torch.dtype) -> None:
        """Take the float form again (a zero ``dtype`` weight until loaded)."""
        if self.is_int8:
            w = self._buffers.pop("weight")
            for name in SCALE_NAMES:
                self._buffers.pop(name, None)
            self.weight = nn.Parameter(torch.zeros(w.shape, dtype=dtype, device=w.device))

    def set_act_scale(self, value: float) -> None:
        """Pin the static activation scale (stored as fp32, JAX's
        ``np.float32(scale)``)."""
        t = torch.tensor(value, dtype=torch.float32)
        if "act_scale" in self._buffers:
            with torch.no_grad():
                self.act_scale.copy_(t)
        else:
            self.register_buffer("act_scale", t.to(self.weight.device))

    def _apply(self, fn, recurse=True):
        """``Module.to`` and its kin, with the int8 scales moved to the new
        device but kept fp32 (``Module.to(dtype)`` casts every floating
        buffer)."""
        scales = {n: self._buffers.pop(n) for n in SCALE_NAMES if n in self._buffers}
        super()._apply(fn, recurse)
        for n, t in scales.items():
            self._buffers[n] = t.to(fn(t).device)
        return self


class ConvNormAct(nn.Module):
    """conv (or DCNv2) + {bn|sync_bn|gn|affine_channel|none} +
    {relu|leaky|mish|none}.  ``frozen`` (set by ``freeze``) and
    ``freeze_norm`` take leaves out of training: their ``requires_grad``
    follows ``param_policy``."""

    def __init__(self, cin: int, cout: int, ksize: int, *, stride: int = 1,
                 bias: bool = False, norm: Optional[str] = None, groups: int = 32,
                 act: Optional[str] = None, use_dcn: bool = False,
                 lr_mult: float = 1.0, bias_lr_mult: Optional[float] = None,
                 freeze_norm: bool = False):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r} is not one of {NORMS}")
        self.cin, self.cout, self.ksize, self.stride = cin, cout, ksize, stride
        self.padding = (ksize - 1) // 2
        self.norm, self.act, self.use_dcn = norm, act, use_dcn
        self.has_bias = bias and not use_dcn
        self.lr_mult = lr_mult
        self.bias_lr_mult = lr_mult if bias_lr_mult is None else bias_lr_mult
        self.freeze_norm = freeze_norm
        self.conv = _ConvParams(cin, cout, ksize, bias, use_dcn)
        self.bn = BatchNorm(cout, sync=norm == "sync_bn") if norm in ("bn", "sync_bn") else None
        self.gn = GroupNorm(cout, groups) if norm == "gn" else None
        self.af = AffineChannel(cout) if norm == "affine_channel" else None
        self._packed = None
        self._packed_key = None
        self._coord_terms: Dict[tuple, torch.Tensor] = {}
        self._coord_key = None
        self.paddle_name = ""
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
        lr_mult everywhere, no weight decay for the norms' params and the
        conv bias, BN running stats never trained."""
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
        tn = t and not self.freeze_norm
        if self.bn is not None:
            pol["bn"] = {"weight": ParamPolicy(self.lr_mult, 0.0, tn),
                         "bias": ParamPolicy(self.lr_mult, 0.0, tn),
                         "running_mean": ParamPolicy(0.0, 0.0, False),
                         "running_var": ParamPolicy(0.0, 0.0, False)}
        for name in ("gn", "af"):
            if getattr(self, name) is not None:
                pol[name] = {"weight": ParamPolicy(self.lr_mult, 0.0, tn),
                             "bias": ParamPolicy(self.lr_mult, 0.0, tn)}
        return pol

    def norm_layer(self) -> Optional[nn.Module]:
        """The norm module (BatchNorm, GroupNorm or AffineChannel), or None."""
        return self.bn if self.bn is not None else (self.gn if self.gn is not None
                                                    else self.af)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions: kaiming-normal conv weight,
        xavier-normal ``dcn_weight``, zero offset conv and biases, identity
        norms (ones and zeros; BN's running stats zero and one)."""
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
        norm = self.norm_layer()
        if norm is not None:
            norm.reset_parameters()

    def _cached_pack(self, w: torch.Tensor, pack) -> torch.Tensor:
        """``pack(w)``, recomputed only when w changes (a new tensor, an
        in-place write, a dtype move), into the cached tensor."""
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if key != self._packed_key:
            old = None if self._packed is None else (self._packed,)
            self._packed = store_cached(old, (pack(w.detach()),))[0]
            self._packed_key = key
        return self._packed

    def packed_dcn_weight(self) -> torch.Tensor:
        """``dcn_weight`` packed for the DCN kernels."""
        from .deform_conv_cuda import pack_dcn_weight

        return self._cached_pack(self.conv.dcn_weight, pack_dcn_weight)

    def packed_int8_weight(self) -> torch.Tensor:
        """The int8 ``weight`` packed for K5."""
        return self._cached_pack(self.conv.weight, pack_int8_weight)

    def refresh_cache(self) -> None:
        """Re-pack the cached DCN or int8 weight, and the folded stem when
        this is the module that holds it, into their existing tensors."""
        if self._packed is not None:
            if self.use_dcn:
                self.packed_dcn_weight()
            elif self.conv.is_int8:
                self.packed_int8_weight()
        if self._coord_terms:
            self._refresh_coord_terms()
        stem = getattr(self, "_stem_cache", None)
        if stem is not None:
            from .stem import stem_params

            stem_params(stem[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        rec = getattr(_RECORD, "rec", None)
        if rec is not None and not self.use_dcn:
            rec[self] = x.float().abs().amax()
        if self.use_dcn:
            om = F.conv2d(x, c.conv_offset.weight, c.conv_offset.bias,
                          self.stride, self.padding)
            # the cached packed weight has no gradient: serving only (and
            # not while torch.export traces: its key reads data pointers)
            packed = (self.packed_dcn_weight()
                      if x.is_cuda and not needs_grad(x, c.dcn_weight, om)
                      and not torch.compiler.is_exporting() else None)
            x = deform_conv2d(x, c.dcn_weight, om, stride=self.stride,
                              padding=self.padding, packed_weight=packed)
        elif c.is_int8 and torch.compiler.is_exporting():
            # the artifact's node (eval/export.py): scale and packing in the program
            s_x = c._buffers.get("act_scale")
            x = torch.ops.ppyolo.quantized_conv2d(
                x, c.weight, pack_int8_weight(c.weight), c.weight_scale,
                dynamic_act_scale(x) if s_x is None else s_x, c.bias, self.stride, self.padding)
        elif c.is_int8:
            # int8 serving form (eval/optimize.py::quantize_params_int8)
            x = quantized_conv2d(x, c.weight, c.weight_scale, stride=self.stride,
                                 padding=self.padding, bias=c.bias,
                                 act_scale=c._buffers.get("act_scale"),
                                 packed=self.packed_int8_weight() if x.is_cuda else None)
        else:
            x = F.conv2d(x, c.weight, c.bias, self.stride, self.padding)
        return self._norm_act(x)

    def _norm_act(self, x: torch.Tensor) -> torch.Tensor:
        """The norm, then the activation (``ppyolo_tpu/ops/conv.py::_norm_act``)."""
        if self.bn is not None and self.bn.training and x.is_cuda and self.act in BN_TRAIN_ACTS:
            return self.bn(x, self.act)   # K7 applies the activation (ops/bn_train.py)
        norm = self.norm_layer()
        if norm is not None:
            x = norm(x)
        return apply_act(x, self.act)

    def forward_parts(self, parts: Sequence[torch.Tensor], *, coord: bool = False) -> torch.Tensor:
        """The layer over the channel concat of ``parts`` without writing
        it: ``sum_i conv(part_i, W[:, off_i:off_i + c_i])``, the bias, then
        one norm and activation (``ppyolo_tpu/ops/conv.py::apply_parts``).
        A batch-1 part broadcasts through the sum.  With ``coord`` the last
        part is the CoordConv planes (``ops/blocks.py::coord_planes``):
        fixed for a grid, so outside autograd their term is computed once
        per (grid, dtype, device) and kept until the weight changes
        (``refresh_cache`` recomputes it in place).

        Rounding: the partial sums of a bf16 layer are added in fp32 and
        rounded once, as the JAX package's ``preferred_element_type``
        does, except that a 3x3 part's conv (cuDNN, which writes bf16) is
        rounded to bf16 before the fp32 sum.  The 1x1 parts run as one
        bf16 GEMM with an fp32 output on the card (``torch.mm(...,
        out_dtype=)``) and as an fp32 conv of the bf16 values on the CPU
        (exact products, fp32 sums); the coordinate term is an fp32 conv.
        DCN and int8 weights take the materialized concat, as in JAX.
        Under ``recording()`` the recorded abs-max is the largest over the
        parts, the concat's."""
        if len(parts) == 1:
            return self(parts[0])
        c = self.conv
        if self.use_dcn or c.is_int8:
            n = max(p.shape[0] for p in parts)
            return self(torch.cat([p.expand(n, *p.shape[1:]) for p in parts], dim=1))
        rec = getattr(_RECORD, "rec", None)
        if rec is not None:
            rec[self] = torch.stack([p.float().abs().amax() for p in parts]).amax()
        dt = parts[0].dtype
        acc = torch.promote_types(dt, torch.float32)
        w = c.weight
        y, off = None, 0
        for i, p in enumerate(parts):
            pc = p.shape[1]
            if coord and i == len(parts) - 1:
                yi = self._coord_term(p, off, acc)
            else:
                yi = self._part_conv(p, w[:, off:off + pc], acc)
            y = yi if y is None else y + yi
            off += pc
        if off != self.cin:
            raise ValueError(f"forward_parts: parts hold {off} channels, the layer takes "
                             f"{self.cin}")
        if c.bias is not None:
            y = y + c.bias.to(acc).view(1, -1, 1, 1)
        return self._norm_act(y.to(dt))

    def _part_conv(self, p: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
        """One part's conv with the sum in ``acc`` (see ``forward_parts``)."""
        if p.dtype == acc:
            return F.conv2d(p, w, None, self.stride, self.padding)
        if self.ksize != 1 or self.stride != 1:
            return F.conv2d(p, w, None, self.stride, self.padding).to(acc)
        if p.is_cuda and not needs_grad(p, w):
            n, ch, h, wd = p.shape
            y = torch.mm(p.permute(0, 2, 3, 1).reshape(-1, ch), w.reshape(w.shape[0], ch).t(),
                         out_dtype=acc)
            return y.view(n, h, wd, -1).permute(0, 3, 1, 2)
        return F.conv2d(p.to(acc), w.to(acc), None, self.stride, self.padding)

    def _coord_term(self, planes: torch.Tensor, off: int, acc: torch.dtype) -> torch.Tensor:
        """The CoordConv planes' term of ``forward_parts`` in ``acc``."""
        w = self.conv.weight
        if needs_grad(w) or torch.compiler.is_exporting():
            return F.conv2d(planes.to(acc), w[:, off:].to(acc), None, self.stride, self.padding)
        if (w.data_ptr(), w._version, w.dtype, w.device) != self._coord_key:
            self._refresh_coord_terms()
        key = (tuple(planes.shape), planes.dtype, planes.device, off, acc)
        t = self._coord_terms.get(key)
        if t is None:
            with torch.no_grad():
                t = self._coord_terms[key] = F.conv2d(
                    planes.to(acc), w[:, off:].to(acc), None, self.stride, self.padding)
        return t

    def _refresh_coord_terms(self) -> None:
        """Recompute every kept coordinate term into its tensor."""
        from .blocks import coord_planes

        w = self.conv.weight
        with torch.no_grad():
            for (shape, dtype, device, off, acc), t in self._coord_terms.items():
                planes = coord_planes(shape[2], shape[3], dtype, device)
                store_cached((t,), (F.conv2d(planes.to(acc), w[:, off:].to(acc), None,
                                             self.stride, self.padding),))
        self._coord_key = (w.data_ptr(), w._version, w.dtype, w.device)


def param_policy_tree(module: nn.Module) -> Dict[str, Any]:
    """The policy tree of every ConvNormAct under ``module``, keyed by the
    param paths relative to it (the JAX ``param_policy`` tree)."""
    flat = {}
    for name, m in module.named_modules():
        if isinstance(m, ConvNormAct):
            for k, pol in flatten_tree(m.param_policy()).items():
                flat[f"{name}.{k}" if name else k] = pol
    return unflatten_tree(flat)


def match_int8_form(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Give every dense ConvNormAct of ``model`` the form of ``sd``: int8
    where ``<path>.conv.weight`` is int8 (with ``act_scale`` where ``sd``
    has one), float where it is not, so ``model.load_state_dict(sd)``
    takes the tree.  Modules the state dict does not name are left as
    they are."""
    for name, m in model.named_modules():
        if not isinstance(m, ConvNormAct) or m.use_dcn:
            continue
        w = sd.get(f"{name}.conv.weight")
        if w is None:
            continue
        if w.dtype == torch.int8:
            m.conv.to_int8(act_scale=f"{name}.conv.act_scale" in sd)
        else:
            m.conv.to_float(w.dtype)
