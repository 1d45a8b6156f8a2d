"""Checkpoint ingestion: the reference's ``.pt`` and Paddle ``.pdparams`` files.

Counterpart of ``ppyolo_tpu/checkpoint/convert.py``, with the name
contract of the reference converters (1_ppyolo_2x_2pytorch.py /
1_ppyolo_r18vd_2pytorch.py).

``.pt``: the reference's torch ``state_dict`` has the port's keys (the
module tree mirrors the reference's attribute names) and its layout
(OIHW), so nothing is transposed: the JAX package's one real step there,
OIHW -> HWIO, has no counterpart.  Unknown keys and shape mismatches are
skipped and reported.

``.pdparams``: Paddle layer names -> the port's keys through each
ConvNormAct's ``paddle_name``:

  backbone   conv:  '<p>_weights'          bn: 'bn'+<p>[3:]+'_scale|_offset|_mean|_variance'
             stem:  'conv1_i' -> bn 'bnv1_i_*'
             DCN:   '<p>_conv_offset.w_0|b_0', '<p>_weights' -> dcn_weight
  head       conv:  '<p>.conv.weights'     bn: '<p>.bn.scale|offset|mean|var'
  out conv:  'yolo_output.{i}.conv.weights|bias'

Both return the model's full state dict (fp32 CPU tensors), the leaves
the file does not give left as they were.
"""
from __future__ import annotations

import logging
import pickle
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.conv import ConvNormAct

logger = logging.getLogger(__name__)
StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pt`` state dict as numpy arrays on the host.  Raises
    ``ValueError`` when the file does not hold a {name: tensor} dict."""
    try:
        sd = torch.load(path, map_location="cpu")
    except (OSError, EOFError):
        raise
    except Exception as e:
        raise ValueError(f"{path}: not a torch state dict ({type(e).__name__}: {e})") from e
    if not isinstance(sd, Mapping) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path}: not a torch state dict of tensors ({type(sd).__name__})")
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _into(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def convert_torch_state_dict(sd: Mapping[str, np.ndarray],
                             model_or_state_dict) -> StateDict:
    """The model's state dict with every leaf of the reference ``sd`` that
    it has at the same shape replaced (fp32); other keys and shape
    mismatches are skipped and logged."""
    out = _into(model_or_state_dict.state_dict()
                if isinstance(model_or_state_dict, nn.Module) else model_or_state_dict)
    loaded, skipped = 0, []
    for k, v in sd.items():
        v = np.asarray(v)
        if k not in out or tuple(v.shape) != tuple(out[k].shape):
            skipped.append(k)
            continue
        out[k] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        loaded += 1
    if skipped:
        logger.warning("[convert] loaded %d, skipped %d: %s...", loaded, len(skipped),
                       skipped[:5])
    return out


def load_paddle_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pdparams`` file as {paddle_name: ndarray}, without paddle.

    ``fluid.save`` / ``paddle.save`` write a protocol-2 pickle of
    {name: ndarray}, possibly saved under Python 2 (``encoding='latin1'``,
    ``bytes`` keys), carrying the dygraph sidecar
    ``StructuredToParameterName@@`` (dropped) and paddle tensor facades
    instead of ndarrays (anything ``__array__``-convertible is taken).
    Raises ``ValueError`` on any other layout."""
    with open(path, "rb") as f:
        try:
            obj = pickle.load(f, encoding="latin1")
        except Exception as e:
            raise ValueError(
                f"{path}: not a pickle stream ({type(e).__name__}: {e}); "
                "expected the fluid.save/paddle.save .pdparams layout "
                "(protocol-2 pickle of {name: ndarray})") from e
    if not isinstance(obj, dict):
        raise ValueError(
            f"{path}: unpickled to {type(obj).__name__}, expected a dict "
            "of {paddle_name: ndarray}")
    obj.pop("StructuredToParameterName@@", None)
    out: Dict[str, np.ndarray] = {}
    bad = []
    for k, v in obj.items():
        if isinstance(k, bytes):
            k = k.decode("utf-8")
        if isinstance(v, np.ndarray):
            out[k] = v
        elif isinstance(v, (list, tuple, int, float)) or hasattr(v, "__array__"):
            out[k] = np.asarray(v)
        else:
            bad.append((k, type(v).__name__))
    if bad:
        raise ValueError(
            f"{path}: {len(bad)} entries are not array-convertible "
            f"(unknown .pdparams layout?): {bad[:5]}")
    if not out:
        raise ValueError(f"{path}: no weights found in the pickled dict")
    return out


def iter_named_convs(model: nn.Module) -> Iterator[Tuple[str, ConvNormAct]]:
    """(state-dict path, module) of every conv of ``model``'s backbone and
    head, in the JAX ``_iter_convs`` order."""
    names = {id(m): n for n, m in model.named_modules()}
    for part in (model.backbone, model.head):
        for m in part.iter_convs():
            yield names[id(m)], m


_BN_LEAVES = (("weight", "scale"), ("bias", "offset"), ("running_mean", "mean"))


def paddle_names(model: nn.Module) -> Dict[str, str]:
    """{Paddle name: state-dict key} of every leaf a ``.pdparams`` file
    gives ``model`` (module docstring), in the JAX converter's order."""
    out: Dict[str, str] = {}
    for t, conv in iter_named_convs(model):
        p = conv.paddle_name
        if not p:
            continue
        if p.startswith("yolo_output"):
            out[f"{p}.weights"] = f"{t}.conv.weight"
            out[f"{p}.bias"] = f"{t}.conv.bias"
            continue
        if "." in p:   # head-style naming
            out[f"{p}.conv.weights"] = f"{t}.conv.weight"
            bn = {f"{p}.bn.{ps}": leaf for leaf, ps in _BN_LEAVES + (("running_var", "var"),)}
        else:          # backbone-style naming
            base = "bnv" + p[len("conv"):] if p.startswith("conv1_") else "bn" + p[len("res"):]
            if conv.use_dcn:
                out[f"{p}_conv_offset.w_0"] = f"{t}.conv.conv_offset.weight"
                out[f"{p}_conv_offset.b_0"] = f"{t}.conv.conv_offset.bias"
                out[f"{p}_weights"] = f"{t}.conv.dcn_weight"
            else:
                out[f"{p}_weights"] = f"{t}.conv.weight"
            bn = {f"{base}_{ps}": leaf
                  for leaf, ps in _BN_LEAVES + (("running_var", "variance"),)}
        if conv.norm in ("bn", "sync_bn"):
            for pname, leaf in bn.items():
                out[pname] = f"{t}.bn.{leaf}"
    return out


def convert_paddle_state_dict(sd: Mapping[str, np.ndarray], model: nn.Module,
                              state_dict=None) -> StateDict:
    """The model's state dict (or ``state_dict``) with the Paddle leaves
    ``sd`` names in place (fp32); leaves it lacks or gives at another
    shape are left and logged."""
    out = _into(model.state_dict() if state_dict is None else state_dict)
    missing = []
    for pname, key in paddle_names(model).items():
        v = sd.get(pname)
        v = None if v is None else np.asarray(v, np.float32)
        if v is None or key not in out or tuple(v.shape) != tuple(out[key].shape):
            missing.append(key)
            continue
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    if missing:
        logger.warning("[convert] %d leaves not found/mismatched: %s...", len(missing),
                       missing[:5])
    return out


def load_weights(path: str, state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """``state_dict`` with the weights of an entry's ``model_path``: a
    reference ``.pt`` through ``convert_torch_state_dict``, else an npz in
    the JAX package's format (``checkpoint/io.py::load_params_npz``), as the
    JAX entries load them (``train.py:85-88``)."""
    from .io import load_params_npz

    if path.endswith(".pt"):
        return convert_torch_state_dict(load_torch_state_dict(path), state_dict)
    return load_params_npz(path, state_dict)
