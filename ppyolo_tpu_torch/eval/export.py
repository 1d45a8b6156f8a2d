"""Serving-artifact export: the whole detector as one ``torch.export`` program.

Counterpart of ``ppyolo_tpu/eval/export.py``.  ``torch.export`` records the
Detector's predict -- normalize -> backbone -> head -> IoU-aware decode ->
NMS -- with the Detector's weights (BN folded, fp32 or bf16) in the
program's state, and ``torch.export.save`` writes it as one file: serving
needs the bytes and PyTorch, no config and no checkpoint.

Input contract (the uint8 transport of ``Detector.process_image``):
  images  uint8 [B, S, S, 3]  RGB, resized on the host
  im_size fp32  [B, 2]        original (h, w) per image
Output: fp32 [B, keep_top_k, 6] rows (label, score, x0, y0, x1, y1),
-1-padded -- as ``Detector.predict_batch``.  (B, S) are fixed at export;
the program runs on the device it was exported on, on a card as a CUDA
graph replay (``serving_fn``).

Forms.  By default the artifact is portable, as the JAX package's is
(``dcn="onehot"``, ``stem="xla"``): ``dcn="plain"`` traces the plain DCNv2
and ``stem="plain"`` the unfused stem, so the program holds only PyTorch's
own operators.  ``dcn="kernel"`` and ``stem="kernel"`` put the hand-written
kernels in instead, as ``ppyolo::dcn_fwd`` (K1) and ``ppyolo::fused_stem``
(K2) nodes, as JAX's ``--dcn pallas`` puts its Pallas kernel in: such an
artifact needs those operators registered where it loads, i.e. ``import
ppyolo_tpu_torch.ops`` (``load_serving`` does it), and the kernels build
from this package's sources at their first call on a card.  Multiclass
NMS's greedy keep is always the ``ppyolo::nms_keep`` node (its plain
fixpoint ends on the data, which ``torch.export`` cannot trace; K6 on a
card).  An int8 Detector exports too, as the JAX ``export_detector``
does: each int8 conv is a ``ppyolo::quantized_conv2d`` node (K5 on a card)
fed its calibrated scale, or the dynamic one computed in the program; the
CLI (``tools/export_serving.py``) offers fp32 and bf16, as the JAX
package's does.
"""
from __future__ import annotations

import io
from typing import Callable

import numpy as np
import torch
from torch import nn


class _Serve(nn.Module):
    """``Detector._predict`` of one batch as a module for ``torch.export``."""

    def __init__(self, detector):
        super().__init__()
        self.model = detector.model
        self._normalize = detector.normalize

    def forward(self, images: torch.Tensor, im_size: torch.Tensor) -> torch.Tensor:
        return self.model.predict(self._normalize(images), im_size)


def export_detector(detector, *, batch: int, dcn: str = "plain", stem: str = "plain") -> bytes:
    """The serialized predict program of ``detector`` for ``batch`` images
    of its ``target_size`` (module docstring for the forms)."""
    from ..ops.deform_conv import dcn_form
    from ..ops.stem import stem_form

    size, dev = detector.target_size, detector.device
    args = (torch.zeros((batch, size, size, 3), dtype=torch.uint8, device=dev),
            torch.full((batch, 2), float(size), dtype=torch.float32, device=dev))
    with torch.no_grad(), dcn_form(dcn), stem_form(stem):
        program = torch.export.export(_Serve(detector), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(data: bytes) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of an artifact's bytes (the ``ppyolo``
    operators registered first)."""
    import ppyolo_tpu_torch.ops  # noqa: F401  (registers the ppyolo:: operators)

    return torch.export.load(io.BytesIO(data))


def input_spec(program: torch.export.ExportedProgram):
    """(batch, size) of an artifact's images input."""
    user = set(program.graph_signature.user_inputs)
    images = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name in user)
    b, s = images.meta["val"].shape[:2]
    return int(b), int(s)


def program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device an artifact was exported on (its weights')."""
    return next(iter(program.state_dict.values())).device


def serving_fn(program: torch.export.ExportedProgram) -> Callable[[np.ndarray, np.ndarray],
                                                                    np.ndarray]:
    """``serve(images_u8, im_size) -> dets`` of a loaded artifact (numpy in,
    numpy [B, keep_top_k, 6] out), on the device it was exported on: on a
    card each call is one replay of a CUDA graph of the program, captured
    at the first call (``train/graphs.py::Graphs``; run operator by
    operator, the program leaves the card idle most of the time: PERF.md)."""
    from ..train.graphs import Graphs

    fn = program.module()
    units = Graphs(lambda inp: {"det": fn(inp["image"], inp["im_size"])},
                   program_device(program))

    @torch.no_grad()
    def serve(images, im_size) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(images), dtype=torch.uint8)
        s = torch.as_tensor(np.ascontiguousarray(im_size), dtype=torch.float32)
        if units.captures_graphs:
            x, s = x.pin_memory(), s.pin_memory()
        return units({"image": x, "im_size": s})["det"].cpu().numpy()

    return serve


def load_serving(data: bytes) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """An artifact's bytes -> ``serve`` (``serving_fn``)."""
    return serving_fn(load_program(data))


def save_serving(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def load_serving_file(path: str) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    with open(path, "rb") as f:
        return load_serving(f.read())
