"""JAX param tree -> the port's ``state_dict``.

The port's keys are the JAX package's dotted param paths, so the bridge
only transposes conv kernels from HWIO to OIHW (the inverse of
``ppyolo_tpu/checkpoint/convert.py::_oihw_to_hwio``): ``conv.weight``,
``conv.conv_offset.weight`` and ``conv.dcn_weight``.  Every other leaf is
copied as it is.  It takes the params flat, ``{dotted_path: np.ndarray}``
(``flatten_tree`` of the JAX tree), and raises on any key the model lacks
or does not get, and on any shape that does not match.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

CONV_KERNEL_SUFFIXES = (".conv.weight", ".conv.conv_offset.weight", ".conv.dcn_weight")


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def jax_params_to_state_dict(flat: Mapping[str, np.ndarray],
                             model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert flat JAX params for ``model``; the result loads with
    ``model.load_state_dict(..., strict=True)``."""
    want = model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param keys differ: missing {missing[:8]} ({len(missing)}), "
                       f"extra {extra[:8]} ({len(extra)})")
    out = {}
    for k, v in flat.items():
        a = np.array(v, np.float32)  # a writable copy
        if a.ndim == 4 and k.endswith(CONV_KERNEL_SUFFIXES):
            a = hwio_to_oihw(a)
        if tuple(a.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {a.shape} != model's {tuple(want[k].shape)}")
        out[k] = torch.from_numpy(a)
    return out
