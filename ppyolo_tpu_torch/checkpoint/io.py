"""Checkpoint files in the JAX package's on-disk format.

Counterpart of ``ppyolo_tpu/checkpoint/io.py``.  A params npz holds the
dotted JAX param paths with HWIO conv kernels (``bridge.py``), so a file
written by either package loads in the other.  A train-state bundle holds
``params/<path>``, ``velocity/<path>`` (the SGD momentum buffers, zeros
before the first step), ``ema/<path>`` and ``step``.  Loading skips unknown keys and
shape mismatches (reference train.py:156-169, class-count fine-tuning);
writes are atomic (a temporary name, then a rename).
"""
from __future__ import annotations

import glob
import logging
import os
import re
import threading
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .bridge import jax_leaf_to_torch, state_dict_to_jax_params, torch_leaf_to_jax

logger = logging.getLogger(__name__)


def _write_npz_atomic(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """Write to a temporary name, then rename: a crash mid-write never
    leaves a truncated file under the real name (``gc_checkpoints`` skips
    the '.tmp.npz' suffix)."""
    tmp = path + ".tmp.npz"  # np.savez appends .npz to other suffixes
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    _write_npz_atomic(path, state_dict_to_jax_params(state_dict))


def load_params_npz(path: str, state_dict: Mapping[str, torch.Tensor], *,
                    strict: bool = False) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every leaf the file holds at the same shape
    replaced (CPU tensors); other keys and shape mismatches are skipped,
    or raise with ``strict``."""
    out = dict(state_dict)
    skipped = []
    with np.load(path) as data:
        for k in data.files:
            if k not in out:
                skipped.append(k)
                continue
            t = jax_leaf_to_torch(k, data[k])
            if tuple(t.shape) != tuple(out[k].shape):
                if strict:
                    raise ValueError(f"shape mismatch in {k}: {tuple(out[k].shape)} "
                                     f"vs {tuple(t.shape)}")
                skipped.append(k)
                continue
            out[k] = t
    if skipped:
        logger.warning("checkpoint %s: skipped %d keys (shape mismatch / unknown): %s...",
                       path, len(skipped), skipped[:5])
    return out


def _state_to_flat(state) -> Dict[str, np.ndarray]:
    out = {f"params/{k}": v
           for k, v in state_dict_to_jax_params(state.model.state_dict()).items()}
    out.update({f"velocity/{k}": torch_leaf_to_jax(k, v) for k, v in state.velocity().items()})
    if state.ema is not None:
        out.update({f"ema/{k}": torch_leaf_to_jax(k, v) for k, v in state.ema.items()})
    out["step"] = np.asarray(state.step, np.int32)
    return out


def save_train_state(path: str, state) -> None:
    """Params + momentum + EMA + step in one npz."""
    _write_npz_atomic(path, _state_to_flat(state))


@torch.no_grad()
def load_train_state(path: str, state):
    """Restore a bundle into ``state`` in place (and return it): the
    model's params and buffers, the optimizer's momentum buffers, the EMA
    shadow and both step counters.  Every value is copied into the live
    tensor (none is rebound), so a CUDA graph captured on ``state`` steps
    from the restored values.  Unknown keys and shape mismatches are
    skipped in every section, as ``load_params_npz`` skips them."""
    sections = {"params": state.model.state_dict(), "velocity": state.optimizer.bufs,
                "ema": state.ema or {}}
    params, skipped = {}, []
    with np.load(path) as data:
        for k in data.files:
            if k == "step":
                state.set_step(int(data[k]))
                continue
            section, _, key = k.partition("/")
            dst = sections.get(section, {}).get(key)
            t = None if dst is None else jax_leaf_to_torch(key, data[k])
            if t is None or tuple(t.shape) != tuple(dst.shape):
                skipped.append(k)
            elif section == "params":
                params[key] = t
            else:
                dst.copy_(t)
    state.model.load_state_dict(params, strict=False)
    if skipped:
        logger.warning("resume from %s: skipped %d keys (shape mismatch / unknown): %s...",
                       path, len(skipped), skipped[:5])
    return state


class AsyncCheckpointer:
    """Writes checkpoints on a background thread.

    The device-to-host copy happens in the caller (the next step changes
    the tensors in place); the npz encode and the disk write run on the
    thread.  One write at a time: a new save joins the previous one, so
    files land in order.  Call ``wait()`` before reading a file just saved;
    a write's exception is raised there."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _submit(self, *writes: Tuple[str, Dict[str, np.ndarray]]) -> None:
        """Write each ``(path, flat)`` in turn on a new thread."""
        self.wait()

        def run():
            try:
                for path, flat in writes:
                    _write_npz_atomic(path, flat)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def save_params(self, path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
        self._submit((path, state_dict_to_jax_params(state_dict)))

    def save_state(self, path: str, state) -> None:
        self._submit((path, _state_to_flat(state)))

    def save_step(self, params_path: str, state_dict: Mapping[str, torch.Tensor],
                  state_path: str, state) -> None:
        """A step's params and its full train state in one background write,
        so both overlap the steps that follow."""
        self._submit((params_path, state_dict_to_jax_params(state_dict)),
                     (state_path, _state_to_flat(state)))


def resume_step_from_filename(path: str) -> Optional[int]:
    """The iter id of a 'step%08d' name (reference train.py:259-261)."""
    m = re.search(r"step(\d{8})", os.path.basename(path))
    return int(m.group(1)) if m else None


def gc_checkpoints(directory: str, keep: int = 10, pattern: str = "step*.npz") -> None:
    """Keep only the newest ``keep`` checkpoints (reference train.py:467-477);
    atomic-write temporaries ('...npz.tmp.npz') are neither counted nor
    removed."""
    files = sorted(f for f in glob.glob(os.path.join(directory, pattern))
                   if not f.endswith(".tmp.npz"))
    for f in files[:-keep]:
        os.remove(f)
