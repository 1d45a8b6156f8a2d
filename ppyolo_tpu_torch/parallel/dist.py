"""Data parallelism over processes: one rank per card (or per CPU process).

Counterpart of ``ppyolo_tpu/parallel/mesh.py``.  A JAX device maps to a
rank: the layout this mirrors is the JAX package's N processes with one
device each (``tests/test_multihost.py``), where each process reads its own
record shard and contributes ``batch_size`` images a step, so the global
batch is ``world × batch_size``.  Parameters, optimizer state and EMA are
replicated (``broadcast_state`` makes the replicas start equal, as
``put_replicated`` does); gradients and losses are averaged over the ranks
in one bucket (``all_reduce_mean``, the ``lax.pmean`` of
``train_step.py:167-169``); ``norm="sync_bn"`` averages the BN statistics
over the ranks inside the step (``ops/module.py::BatchNorm``).

The group is ``torch.distributed``'s default group, made by
``init_from_env`` (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and the rendezvous address) or by a caller that made it
itself.  The backend follows the device asked for: NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU; a failed NCCL init raises, it never
falls back to gloo.  Without a group every function here is the
one-process identity: ``world()`` is 1 and ``rank()`` 0.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the other ranks wait in the next unit's collective while rank 0 runs the
# periodic COCO eval (and writes checkpoints), so the group's timeout must
# outlast a full val-set eval on a slow host: 5,000 images at 10 img/s
# take under 10 minutes
GROUP_TIMEOUT = datetime.timedelta(minutes=60)

logger = logging.getLogger(__name__)


def active() -> bool:
    """Is a default process group initialised?"""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def local_rank() -> int:
    """The card index of this rank on its host (``LOCAL_RANK``, 0 if unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def init_from_env(device=None, *, init_method: str = "env://") -> torch.device:
    """Join the process group that ``RANK`` / ``WORLD_SIZE`` describe and
    return this rank's device: ``cuda:LOCAL_RANK`` under NCCL (``device``
    None or a cuda device), the CPU under gloo (``device='cpu'``).  Raises
    when a card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the NCCL group; pass "
                               "--use_gpu false to train on the CPU under gloo")
        dev = torch.device("cuda", local_rank() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank_,
                                world_size=world_, timeout=GROUP_TIMEOUT, device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=rank_,
                                world_size=world_, timeout=GROUP_TIMEOUT)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return dev


@contextlib.contextmanager
def env_group(device=None):
    """An entry's process group: under ``torchrun`` (``WORLD_SIZE`` set and
    no group yet) joins it with ``init_from_env`` and yields this rank's
    device, destroying the group on exit; otherwise yields ``device``.
    The entry's CUDA graphs are collected first: a live graph that captured
    NCCL collectives keeps the communicator busy, and the destroy would
    wait for it forever."""
    if "WORLD_SIZE" not in os.environ or active():
        yield device
        return
    dev = init_from_env(device)
    try:
        yield dev
    finally:
        gc.collect()
        dist.destroy_process_group()


def can_capture(device) -> bool:
    """Can a unit of work on ``device`` be captured into a CUDA graph with
    its collectives?  Only on a card, and not under gloo, whose CUDA
    collectives stage through the host: the callers run such units eagerly,
    and this says so in the log."""
    on_card = torch.device(device).type == "cuda"
    if on_card and backend() == "gloo":
        logger.warning("gloo process group: units of work on %s run eagerly, not as "
                       "CUDA graphs", device)
        return False
    return on_card


def barrier() -> None:
    if active():
        dist.barrier()


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (``lax.pmean`` over a tree):
    the tensors are flattened into one bucket per dtype, summed by one
    all-reduce and divided by the world size.  Returns new tensors; the
    inputs are not written.  Without a group, returns the inputs."""
    if not active():
        return list(tensors)
    n = world()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


@torch.no_grad()
def broadcast_state(state, src: int = 0):
    """Rank ``src``'s params, BN statistics, momentum buffers, EMA shadow
    and step copied into every rank's ``state`` in place (one broadcast per
    dtype), so the replicas start identical; returns ``state``."""
    if not active():
        return state
    tensors = list(state.tensors().values())
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))
    state.step = int(state.step_t)
    return state


def make_sharded_predict(detector):
    """``fn(pimages, im_sizes) -> [B, keep_top_k, 6]`` numpy, called by every
    rank with the same batch (``mesh.py:97-115``): rank r predicts the r-th
    contiguous slice of the B images and the slices are all-gathered in
    rank order.  B must divide by the world size.  The gather runs on the
    card under NCCL and on the CPU under gloo (which gathers no CUDA
    tensors)."""
    def predict(pimages: np.ndarray, im_sizes: np.ndarray) -> np.ndarray:
        n, r = world(), rank()
        if pimages.shape[0] % n:
            raise ValueError(f"a batch of {pimages.shape[0]} does not split over {n} ranks")
        b = pimages.shape[0] // n
        mine = detector.predict_batch(pimages[r * b:(r + 1) * b], im_sizes[r * b:(r + 1) * b])
        if n == 1:
            return mine
        dev = detector.device if backend() == "nccl" else torch.device("cpu")
        part = torch.from_numpy(np.ascontiguousarray(mine)).to(dev)
        out = torch.empty((n * b,) + tuple(part.shape[1:]), dtype=part.dtype, device=dev)
        dist.all_gather_into_tensor(out, part)
        return out.cpu().numpy()

    return predict
