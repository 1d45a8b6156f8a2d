"""Config-driven input pipeline with background prefetch and device staging.

Counterpart of ``ppyolo_tpu/data/loader.py``:

* sample transforms built from ``cfg.sample_transforms_seq`` by name;
* batch assembly: one random size per batch from ``cfg.randomShape``,
  images packed to uint8 (normalized on the device) or normalized here,
  and the host ``gt2yolo_targets`` when ``device_targets`` is off;
* ``train_batches``: the infinite shuffled stream, every draw keyed by
  (seed, shard, epoch or iter, slot), so it is bitwise the JAX package's,
  independent of thread order, and fast-forwardable to ``start_iter``;
* ``stack_units``: ``scan_steps`` consecutive batches (one size, through
  ``train_batches(shape_group=scan_steps)``) stacked into one unit of work
  for a multi-step function (``train.py:191-200``);
* ``Prefetcher``: a background thread over a bounded queue that relays a
  producer's exception and can be closed;
* ``DevicePrefetcher``: copies each batch to the card through pinned
  memory on a side CUDA stream, so batch N+1's copy runs beside step N's
  kernels (the JAX package's ``jax.device_put`` double buffer).
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import native
from . import transforms as T
from .coco import get_samples
from .targets import gt2yolo_targets

# the keys a train step reads ('targets' is a sequence of per-level arrays)
BATCH_KEYS = ("image", "gt_bbox", "gt_class", "gt_score", "targets")


def build_sample_transforms(cfg) -> List[T.BaseOperator]:
    ops = []
    for name in cfg.sample_transforms_seq:
        cls = T.SAMPLE_OPS[name]
        kwargs = dict(getattr(cfg, name, {}) or {})
        ops.append(cls(**kwargs))
    return ops


def apply_sample_transforms(sample, ops, rng):
    for op in ops:
        sample = op(sample, rng)
    return sample


def assemble_batch(samples: List[dict], cfg, rng: np.random.RandomState,
                   *, fixed_shape: Optional[int] = None,
                   timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Batch transforms: RandomShape -> NormalizeImage -> Permute ->
    Gt2YoloTarget.  Returns numpy arrays (NHWC) and the batch's ``shape``.

    With ``train_cfg['device_normalize']`` (default on) the images ship as
    uint8 and the train step normalizes them: each sample is resized into
    one reusable fp32 scratch and packed into its batch slot in one native
    rint/clip pass.  ``timings`` accumulates "resize_s"/"pack_s" wall time.
    """
    shape = fixed_shape if fixed_shape is not None else int(
        rng.choice(cfg.randomShape["sizes"]))
    shaper = T.RandomShapeSingle(random_inter=cfg.randomShape.get("random_inter", False))
    normalizer = T.NormalizeImage(**cfg.normalizeImage)
    permuter = T.Permute(**cfg.permute)
    if bool(cfg.train_cfg.get("device_normalize", True)):
        s_int = int(shape)
        images = np.empty((len(samples), s_int, s_int, 3), np.uint8)
        scratch = np.empty((s_int, s_int, 3), np.float32)
        for i, s in enumerate(samples):
            t0 = time.perf_counter() if timings is not None else 0.0
            shaper(shape, s, rng, dst=scratch)
            permuter(s, rng)
            if timings is not None:
                t1 = time.perf_counter()
                timings["resize_s"] = timings.get("resize_s", 0.0) + t1 - t0
                t0 = t1
            img = s["image"]
            if img.dtype == np.float32:
                if not img.flags.c_contiguous:  # e.g. Permute(to_bgr=True)
                    img = np.ascontiguousarray(img)
                if not native.pack_u8(img, images[i]):
                    np.rint(img, out=img)
                    np.clip(img, 0.0, 255.0, out=img)
                    images[i] = img  # integral-valued: the cast is exact
            elif img.dtype == np.uint8:
                # every p<1 augmentation missed: rint/clip are identities
                images[i] = img
            else:
                images[i] = np.clip(np.rint(img), 0.0, 255.0).astype(np.uint8)
            if timings is not None:
                timings["pack_s"] = timings.get("pack_s", 0.0) + time.perf_counter() - t0
    else:
        for s in samples:
            shaper(shape, s, rng)
            normalizer(s, rng)
            permuter(s, rng)
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
    gt_bbox = np.stack([s["gt_bbox"] for s in samples]).astype(np.float32)
    gt_class = np.stack([np.reshape(s["gt_class"], (-1,)) for s in samples]).astype(np.int32)
    gt_score = np.stack([np.reshape(s["gt_score"], (-1,)) for s in samples]).astype(np.float32)
    batch = {"image": images, "gt_bbox": gt_bbox, "gt_class": gt_class,
             "gt_score": gt_score, "shape": shape}
    if not cfg.train_cfg.get("device_targets", True):
        tcfg = cfg.gt2YoloTarget
        batch["targets"] = tuple(gt2yolo_targets(
            gt_bbox, gt_class, gt_score, (shape, shape), tcfg["anchors"],
            tcfg["anchor_masks"], tcfg["downsample_ratios"], tcfg["num_classes"],
            iou_thresh=tcfg.get("iou_thresh", 1.0)))
    return batch


def train_batches(records: List[dict], cfg, *, seed: int = 0, start_iter: int = 0,
                  fixed_shape: Optional[int] = None, shape_group: int = 1,
                  num_shards: int = 1, shard_id: int = 0) -> Iterator[Dict[str, Any]]:
    """Infinite shuffled batch stream (reference read_train_data).

    ``shape_group > 1`` keeps the input size for that many consecutive
    batches.  ``num_shards``/``shard_id`` read a disjoint slice of the
    records (the size schedule ignores the shard).  With
    ``train_cfg['num_threads'] > 1`` the per-sample transforms run on a
    thread pool (cv2 releases the GIL), each sample on its own keyed
    ``RandomState``; the pool is shut down when the generator is closed.
    """
    if num_shards > 1:
        records = records[shard_id::num_shards]
    tc = cfg.train_cfg
    batch_size = tc["batch_size"]
    n = len(records)
    steps_per_epoch = max(n // batch_size, 1)
    with_mixup = cfg.decodeImage.get("with_mixup", False)
    with_cutmix = cfg.decodeImage.get("with_cutmix", False)
    mixup_steps = tc.get("mixup_epoch", 0) * steps_per_epoch
    cutmix_steps = tc.get("cutmix_epoch", 0) * steps_per_epoch
    sample_ops = build_sample_transforms(cfg)
    n_threads = int(tc.get("num_threads", 0) or 0)
    M31 = 2 ** 31 - 1

    def epoch_rng(epoch):
        return np.random.RandomState((seed + 7919 * shard_id + 104729 * epoch) % M31)

    def iter_rng(it, slot=0):
        return np.random.RandomState((seed + 7919 * shard_id + 101 * slot + 15485863 * it) % M31)

    def group_shape(it):
        if fixed_shape is not None:
            return fixed_shape
        gidx = (it - 1) // max(shape_group, 1)
        srng = np.random.RandomState((seed + 6151 * gidx) % M31)
        return int(srng.choice(cfg.randomShape["sizes"]))

    iter_id = start_iter
    epoch = start_iter // steps_per_epoch
    step0 = start_iter % steps_per_epoch
    pool = ThreadPoolExecutor(n_threads) if n_threads > 1 else None
    try:
        while True:
            indexes = np.arange(n)
            epoch_rng(epoch).shuffle(indexes)
            for step in range(step0, steps_per_epoch):
                iter_id += 1
                shape = group_shape(iter_id)
                it_rng = iter_rng(iter_id)
                samples = get_samples(records, indexes, step, batch_size, iter_id, with_mixup,
                                      with_cutmix, mixup_steps, cutmix_steps, it_rng)
                if pool is not None:
                    it = iter_id
                    samples = list(pool.map(
                        lambda iv: apply_sample_transforms(iv[1], sample_ops,
                                                           iter_rng(it, iv[0] + 1)),
                        enumerate(samples)))
                else:
                    samples = [apply_sample_transforms(s, sample_ops, it_rng) for s in samples]
                yield assemble_batch(samples, cfg, it_rng, fixed_shape=shape)
            epoch += 1
            step0 = 0
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def stack_units(batches: Iterable[Dict[str, Any]], n_steps: int) -> Iterator[Dict[str, Any]]:
    """The batches themselves for ``n_steps`` 1, else units of ``n_steps``
    consecutive batches: each ``BATCH_KEYS`` array stacked on a new leading
    axis ('targets' level by level), other keys (``shape``) from the first
    batch.  Ends when fewer than ``n_steps`` batches remain."""
    if n_steps <= 1:
        yield from batches
        return
    it = iter(batches)
    while True:
        group = list(itertools.islice(it, n_steps))
        if len(group) < n_steps:
            return
        unit = dict(group[0])
        for k in BATCH_KEYS:
            if k == "targets" and k in unit:
                unit[k] = tuple(np.stack(lv) for lv in zip(*(g[k] for g in group)))
            elif k in unit:
                unit[k] = np.stack([g[k] for g in group])
        yield unit


class Prefetcher:
    """Runs an iterator on a background thread into a bounded queue.

    A producer exception is raised from ``__next__`` (a failed read must not
    look like the end of the stream).  ``close()`` stops the thread, closes
    the iterator when it is a generator (running its ``finally``), and
    waits for both; the instance is also a context manager.
    """

    def __init__(self, it: Iterator, max_batch: int = 3):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=max_batch)
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    break
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._error = e
        finally:
            close = getattr(self._it, "close", None)
            if close is not None:
                close()
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._stop.set()
            if self._error is not None:
                raise RuntimeError("data producer thread failed") from self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("data producer thread did not stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def host_to_device(batch: Dict[str, Any], device: torch.device,
                   stream: Optional["torch.cuda.Stream"] = None) -> Dict[str, Any]:
    """The ``BATCH_KEYS`` of a host batch as tensors on ``device``.  To a
    card each array is staged in pinned memory and copied asynchronously
    on ``stream`` (the current stream by default); on the CPU the tensors
    share the arrays' memory."""
    def put(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        return {k: (tuple(put(t) for t in batch[k]) if k == "targets" else put(batch[k]))
                for k in BATCH_KEYS if k in batch}


def _tensors(batch: Dict[str, Any]):
    for v in batch.values():
        yield from (v if isinstance(v, tuple) else (v,))


class DevicePrefetcher:
    """Stages each host batch on the device while the card still runs the
    step before it.

    On a card, a batch is taken from the host iterator only when the caller
    asks for it (after it enqueued the previous step, so a slow loader
    never sits in front of a step already taken), staged in pinned memory
    and copied on a side stream: the copy runs beside the previous step's
    kernels.  The current stream waits on the copy's event, and the
    tensors are marked as used on it (``record_stream``), so the allocator
    does not reuse them early.  On the CPU the tensors pass straight
    through.  Yields ``(device_batch, host_batch)``: the host batch's other
    keys (``shape``) stay readable.
    """

    def __init__(self, it: Iterator[Dict[str, Any]], device: torch.device):
        self._it = iter(it)
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __iter__(self):
        return self

    def __next__(self):
        host = next(self._it)
        dev = host_to_device(host, self._device, self._stream)
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in _tensors(dev):
                t.record_stream(current)
        return dev, host
