"""The JAX param tree <-> the port's ``state_dict``, both ways.

The port's keys are the JAX package's dotted param paths, so the bridge
only transposes conv kernels between HWIO (JAX) and OIHW (torch), the
inverse of ``ppyolo_tpu/checkpoint/convert.py::_oihw_to_hwio`` and that
function itself: ``conv.weight``, ``conv.conv_offset.weight`` and
``conv.dcn_weight``.  Every other leaf is copied as it is.  The JAX side
is flat, ``{dotted_path: np.ndarray}`` (``flatten_tree`` of the JAX tree),
which is also the on-disk npz layout of both packages.

An int8 serving tree (``optimize_for_inference(precision="int8")`` of
either package) crosses too: int8 conv weights stay int8 (HWIO <-> OIHW),
``weight_scale`` and the 0-d ``act_scale`` stay fp32, and the bf16 leaves
travel as fp32 (exact; numpy has no bf16), so every value crosses bitwise.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.conv import match_int8_form

CONV_KERNEL_SUFFIXES = (".conv.weight", ".conv.conv_offset.weight", ".conv.dcn_weight")


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def is_conv_kernel(key: str, ndim: int) -> bool:
    return ndim == 4 and key.endswith(CONV_KERNEL_SUFFIXES)


def jax_leaf_to_torch(key: str, value) -> torch.Tensor:
    """One JAX leaf as the port's tensor (a writable CPU copy)."""
    a = np.array(value)
    return torch.from_numpy(hwio_to_oihw(a) if is_conv_kernel(key, a.ndim) else a)


def torch_leaf_to_jax(key: str, t: torch.Tensor) -> np.ndarray:
    """One port tensor as the JAX leaf (numpy, on the host; bf16 as fp32)."""
    t = t.detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return oihw_to_hwio(a) if is_conv_kernel(key, a.ndim) else np.array(a)


def jax_params_to_state_dict(flat: Mapping[str, np.ndarray],
                             model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert flat JAX params for ``model``; the result loads with
    ``model.load_state_dict(..., strict=True)``.  Float leaves become fp32,
    int8 leaves stay int8 (and ``model`` takes the int8 form of such a
    tree, ``ops/conv.py::match_int8_form``).  Raises on any key the model
    lacks or does not get, and on any shape that does not match."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    match_int8_form(model, {k: torch.empty(0, dtype=torch.int8 if v.dtype == np.int8
                                           else torch.float32) for k, v in flat.items()})
    want = model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param keys differ: missing {missing[:8]} ({len(missing)}), "
                       f"extra {extra[:8]} ({len(extra)})")
    out = {}
    for k, v in flat.items():
        t = jax_leaf_to_torch(k, v if v.dtype == np.int8 else np.asarray(v, np.float32))
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != model's {tuple(want[k].shape)}")
        out[k] = t
    return out


def state_dict_to_jax_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's state dict (any device, any dtype) as flat JAX params:
    numpy on the host, conv kernels HWIO."""
    return {k: torch_leaf_to_jax(k, t) for k, t in sd.items()}
