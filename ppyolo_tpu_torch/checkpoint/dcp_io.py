"""Full train-state checkpoints through ``torch.distributed.checkpoint``.

Counterpart of ``ppyolo_tpu/checkpoint/orbax_io.py``:
``train_cfg['ckpt_backend'] = 'orbax'`` selects it in the port, so the JAX
package's configs run unchanged.  It is a second format beside the npz
files of ``checkpoint/io.py``, which stay the interchange with the JAX
package (rank 0 writes those in every run).

Every rank takes part in a save (DCP plans it collectively and writes each
replicated tensor once, from rank 0: under ``norm_type='bn'`` the BN
running statistics are each rank's own, and the file holds rank 0's, as
the npz files do) and every rank restores the whole state.  A step is
written into ``step_%08d.tmp`` and renamed to ``step_%08d`` by rank 0 once
every rank has written (the commit); a barrier follows, so no rank sees a
step before it is whole.  ``latest_step`` reads the committed names only;
the newest ``keep`` steps are kept.  Without a process group it works in
one process.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

import torch
import torch.distributed.checkpoint as dcp

from ..parallel import dist

_STEP_DIR = re.compile(r"step_(\d{8})$")


class DCPCheckpointer:
    """DCP checkpoints of a ``TrainState`` under ``directory``."""

    def __init__(self, directory: str, *, keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        if dist.rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        dist.barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def steps(self) -> List[int]:
        """The committed steps, ascending."""
        found = (_STEP_DIR.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Every rank calls this at the same step."""
        final = self._path(step)
        tmp = final + ".tmp"
        if dist.rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        dist.barrier()
        dcp.save(state.tensors(), checkpoint_id=tmp,
                 planner=dcp.DefaultSavePlanner(dedup_save_to_lowest_rank=True))
        if dist.rank() == 0:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.steps()[:-self.keep]:
                shutil.rmtree(self._path(old))
        dist.barrier()

    @torch.no_grad()
    def restore(self, state, step: Optional[int] = None):
        """Load a committed step (default the latest) into ``state`` in
        place, on every rank; returns ``state``, untouched when there is
        no step."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return state
        dcp.load(state.tensors(), checkpoint_id=self._path(step))
        state.step = int(state.step_t)
        return state
