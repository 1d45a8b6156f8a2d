"""Batched detector: host preprocessing, then backbone -> head -> decode ->
Matrix-NMS on the device with one [B, keep_top_k, 6] copy back.

Counterpart of ``ppyolo_tpu/eval/detector.py::Detector``.  Images travel to
the device as uint8 NHWC, staged through pinned memory, and are
normalized there; the NHWC batch viewed as NCHW is ``channels_last``, so no
layout copy happens.  On a card a predict is one replay of a CUDA graph
(``train/graphs.py``), captured at the first batch of each (batch, size)
and, for ``predict_pipelined``, group: the host copies the batch into the
graph's input, replays and copies the detections out (the JAX package's
jitted ``predict_batch`` and scanned ``predict_pipelined``).  On the CPU
the same function runs eagerly.  The Detector casts, re-lays and BN-folds
the model it is given, so it needs a model of its own (never the one being
trained): ``set_params`` loads new weights into it in place.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.module import resolve_device
from ..train.graphs import Graphs
from .optimize import COMPUTE_DTYPES, optimize_for_inference


class Detector:
    def __init__(self, model, state_dict, cfg, *, target_size: Optional[int] = None,
                 precision: str = "fp32", fold_bn: bool = True, device=None):
        """``state_dict`` uses the port's keys (the JAX param paths), fp32.
        ``device`` defaults to ``cuda`` and raises if there is no card."""
        self.device = resolve_device(device)
        self.compute_dtype = COMPUTE_DTYPES[precision]
        self._precision, self._fold_bn = precision, fold_bn
        self.model = model.to(device=self.device, dtype=self.compute_dtype,
                              memory_format=torch.channels_last).eval()
        self.set_params(state_dict)
        self.target_size = int(target_size or cfg.test_cfg["target_size"])
        mean = np.array(cfg.normalizeImage["mean"], np.float32)
        std = np.array(cfg.normalizeImage["std"], np.float32)
        self.interp = int(cfg.resizeImage.get("interp", 2))
        self.is_scale = bool(cfg.normalizeImage.get("is_scale", True))
        self.to_bgr = bool(cfg.permute.get("to_bgr", False))
        if self.to_bgr:
            # the channels flip before the uint8 ship, so the constants flip too
            mean, std = mean[::-1].copy(), std[::-1].copy()
        self.mean = torch.from_numpy(mean).to(self.device).view(1, 3, 1, 1)
        self.std = torch.from_numpy(std).to(self.device).view(1, 3, 1, 1)
        self._graphs = {}   # group -> Graphs, all in one memory pool
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    def set_params(self, state_dict) -> None:
        """Load new weights (the port's keys, fp32, any device), BN folded
        and cast as at construction; the model and its caches stay."""
        sd = optimize_for_inference(state_dict, precision=self._precision,
                                    fold_bn=self._fold_bn)
        self.model.load_state_dict(sd)

    def process_image(self, img_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """BGR->RGB + uint8 cv2 resize on the host (reference decode_np.py:125-140)."""
        import cv2

        im = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
        h, w = im.shape[:2]
        ts = self.target_size
        im = cv2.resize(im, (ts, ts), interpolation=self.interp)
        if self.to_bgr:
            im = im[..., ::-1]
        return im[None], np.array([[h, w]], np.float32)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """[B,S,S,3] uint8 (or normalized float) NHWC -> [B,3,S,S] in the
        compute dtype, channels_last; op-for-op the JAX ``_normalize``."""
        x = images.permute(0, 3, 1, 2)
        if x.dtype == torch.uint8:
            x = x.float()
            if self.is_scale:
                x = x / 255.0
            x = (x - self.mean) / self.std
        return x.to(self.compute_dtype)

    def _predict(self, images: torch.Tensor, im_size: torch.Tensor, group: int) -> torch.Tensor:
        """``group`` batches of [G*B,S,S,3] images in turn -> [G*B, K, 6]."""
        if group == 1:
            return self.model.predict(self.normalize(images), im_size)
        ims, szs = images.chunk(group), im_size.chunk(group)
        return torch.cat([self.model.predict(self.normalize(i), s) for i, s in zip(ims, szs)])

    @torch.no_grad()
    def _run(self, pimages: np.ndarray, im_sizes: np.ndarray, group: int) -> np.ndarray:
        images = torch.from_numpy(np.ascontiguousarray(pimages))
        sizes = torch.from_numpy(np.ascontiguousarray(im_sizes, np.float32))
        if self.device.type != "cuda":
            return self._predict(images.to(self.device), sizes.to(self.device),
                                 group).cpu().numpy()
        if group not in self._graphs:
            self._graphs[group] = Graphs(
                lambda inp: {"det": self._predict(inp["image"], inp["im_size"], group)},
                self.device, pool=self._pool, model=self.model)
        # pinned, so the copies into the graph's inputs are asynchronous
        out = self._graphs[group]({"image": images.pin_memory(), "im_size": sizes.pin_memory()})
        return out["det"].cpu().numpy()

    def predict_batch(self, pimages: np.ndarray, im_sizes: np.ndarray) -> np.ndarray:
        """pimages [B,S,S,3] preprocessed; im_sizes [B,2] (h, w).
        Returns [B, keep_top_k, 6] numpy (label, score, x0, y0, x1, y1)."""
        return self._run(pimages, im_sizes, 1)

    def predict_pipelined(self, pimages: np.ndarray, im_sizes: np.ndarray, *,
                          group: int) -> np.ndarray:
        """``group`` batches in one unit of work (one graph replay on a card):
        pimages [G*B,S,S,3], im_sizes [G*B,2].  Returns [G*B, keep_top_k, 6],
        each batch's rows as ``predict_batch`` gives them."""
        if group < 1 or pimages.shape[0] % group:
            raise ValueError(f"{pimages.shape[0]} images do not split into {group} batches")
        return self._run(pimages, im_sizes, group)

    def detect_image(self, img_bgr: np.ndarray, draw_thresh: Optional[float] = None):
        """One BGR image -> (boxes [K,4] xyxy, scores [K], classes [K])
        (reference decode_np.py:41-96)."""
        pimage, im_size = self.process_image(img_bgr)
        pred = self.predict_batch(pimage, im_size)[0]
        keep = pred[:, 0] >= 0
        if draw_thresh is not None:
            keep &= pred[:, 1] >= draw_thresh
        return pred[keep, 2:6], pred[keep, 1], pred[keep, 0].astype(np.int32)

    def detect_batch(self, imgs_bgr: List[np.ndarray]):
        """BGR images -> one (boxes, scores, classes) per image."""
        pimages, sizes = zip(*(self.process_image(im) for im in imgs_bgr))
        preds = self.predict_batch(np.concatenate(pimages), np.concatenate(sizes))
        results = []
        for pred in preds:
            keep = pred[:, 0] >= 0
            results.append((pred[keep, 2:6], pred[keep, 1], pred[keep, 0].astype(np.int32)))
        return results
