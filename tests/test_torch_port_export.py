"""The port's serving artifact (``ppyolo_tpu_torch/eval/export.py``) and its
two tools, on the CPU: the counterparts of ``tests/test_export.py``.

Round trip: export -> bytes -> load equals ``Detector.predict_batch`` of
the same Detector within the JAX test's rtol = atol = 1e-6 (measured:
bitwise, every case) for r18vd at 128 px (fp32, b2) in the plain and the
kernel forms, and for mini-2x (DCN in stage 5) at 96 px in fp32 and bf16,
where the kernel form holds ``ppyolo::dcn_fwd`` and, in bf16,
``ppyolo::fused_stem`` nodes (their CPU implementations: the plain
versions) and the plain form none.  Multiclass NMS exports through its
``ppyolo::nms_keep`` node.  An int8 Detector exports as the JAX package's
does, each int8 conv a ``ppyolo::quantized_conv2d`` node, with dynamic and
with calibrated scales.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import configs
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.eval.export import (export_detector, input_spec, load_program,
                                          load_serving, load_serving_file, save_serving,
                                          serving_fn)
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops.stem import stem_form

from test_torch_port_train import mini2x_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _r18_cfg(nms_type="matrix_nms"):
    cfg = configs.PPYOLO_r18vd_Config()
    cfg.num_classes = 6
    cfg.head = dict(cfg.head, num_classes=6)
    cfg.nms_cfg = dict(cfg.nms_cfg, nms_type=nms_type)
    return cfg


def _detector(cfg, size, precision="fp32", seed=0):
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    r = np.random.RandomState(seed + 1)
    for k in sorted(sd):
        if "conv_offset" in k:
            sd[k] = torch.from_numpy((r.randn(*sd[k].shape) * 0.02).astype(np.float32))
    return Detector(model, sd, cfg, target_size=size, precision=precision, device="cpu")


def _batch(size, seed=0):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (2, size, size, 3)).astype(np.uint8),
            np.array([[97.0, 153.0], [size, 64.0]], np.float32))


def _ppyolo_ops(program):
    return sorted({str(n.target).split(".")[1] for n in program.graph.nodes
                   if str(n.target).startswith("ppyolo.")})


@pytest.mark.parametrize("form", ["plain", "kernel"])
def test_export_roundtrip_matches_direct_predict(form, tmp_path):
    det = _detector(_r18_cfg(), 128)
    data = export_detector(det, batch=2, dcn=form, stem=form)
    assert len(data) > 1_000_000                      # the weights are in it
    images, sizes = _batch(128)
    direct = det.predict_batch(images, sizes)
    assert (direct[..., 0] >= 0).any()
    got = load_serving(data)(images, sizes)
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, direct)
    path = str(tmp_path / "det.pt2")
    save_serving(path, data)
    np.testing.assert_allclose(load_serving_file(path)(images, sizes), direct,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("form", ["plain", "kernel"])
def test_export_forms_hold_the_kernels_as_operators(precision, form):
    det = _detector(mini2x_cfg(), 96, precision)
    images, sizes = _batch(96, 1)
    program = load_program(export_detector(det, batch=2, dcn=form, stem=form))
    want = {"plain": [], "kernel": ["dcn_fwd"] + (["fused_stem"] if precision == "bf16" else [])}
    assert _ppyolo_ops(program) == sorted(want[form])
    assert input_spec(program) == (2, 96)
    with stem_form(form if precision == "bf16" else "auto"):
        direct = det.predict_batch(images, sizes)    # the unfused stem in the plain form
    got = serving_fn(program)(images, sizes)
    assert (direct[..., 0] >= 0).any()
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, direct)


def test_multiclass_nms_exports_through_its_keep_operator():
    det = _detector(_r18_cfg("multiclass_nms"), 128)
    program = load_program(export_detector(det, batch=2))
    assert _ppyolo_ops(program) == ["nms_keep"]
    images, sizes = _batch(128, 2)
    direct = det.predict_batch(images, sizes)
    assert (direct[..., 0] >= 0).any()
    assert np.array_equal(serving_fn(program)(images, sizes), direct)


def test_int8_export_raises():
    """int8 export used to raise (the JAX tool offers fp32 and bf16 only);
    the JAX ``export_detector`` exports an int8 Detector
    (``test_jax_exports_int8``), so the port's does too: at b1 the round
    trip is bitwise ``predict_batch``, and nothing raises."""
    det = _detector(_r18_cfg(), 64, "int8")
    images, sizes = _batch(64)
    program = load_program(export_detector(det, batch=1))
    assert _ppyolo_ops(program) == ["quantized_conv2d"]
    with stem_form("plain"):    # the plain form's unfused stem
        direct = det.predict_batch(images[:1], sizes[:1])
    assert np.array_equal(serving_fn(program)(images[:1], sizes[:1]), direct)


def _quantized_nodes(program):
    return sum(str(n.target) == "ppyolo.quantized_conv2d.default" for n in program.graph.nodes)


def test_jax_exports_int8():
    """The JAX package's ``export_detector`` exports and round-trips an int8
    Detector (r18vd, 64 px, dynamic scales: bitwise its ``predict_batch``),
    which is why the port exports int8 too."""
    import jax

    from ppyolo_tpu.eval.detector import Detector as JaxDetector
    from ppyolo_tpu.eval.export import export_detector as jax_export
    from ppyolo_tpu.eval.export import load_serving as jax_load
    from ppyolo_tpu.models import PPYOLO as JaxPPYOLO

    cfg = _r18_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    det = JaxDetector(jm, jm.init(jax.random.PRNGKey(0)), cfg, target_size=64,
                      precision="int8")
    images, sizes = _batch(64)
    direct = np.asarray(det.predict_batch(images, sizes))
    assert (direct[..., 0] >= 0).any()
    assert np.array_equal(np.asarray(jax_load(jax_export(det, batch=2))(images, sizes)), direct)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("model", ["r18vd", "mini2x"])
def test_int8_export_roundtrip_is_bitwise(model, calibrated):
    """The int8 artifact equals ``Detector(precision="int8").predict_batch``
    bitwise, with dynamic scales (computed in the program) and calibrated
    ones; the kernel form holds the convs as ``ppyolo::quantized_conv2d``
    nodes (K5 on a card), the DCN as ``ppyolo::dcn_fwd`` and the stem as
    ``ppyolo::fused_stem``."""
    cfg, size = (_r18_cfg(), 128) if model == "r18vd" else (mini2x_cfg(), 64)
    det = _detector(cfg, size, "int8")
    images, sizes = _batch(size, 3)
    if calibrated:
        assert det.calibrate(images) > 0
    program = load_program(export_detector(det, batch=2, dcn="kernel", stem="kernel"))
    quantized = sum(m.conv.is_int8 for m in det.model.modules() if hasattr(m, "conv")
                    and hasattr(m.conv, "is_int8"))
    assert _quantized_nodes(program) == quantized > 0
    want = ["dcn_fwd"] if model == "mini2x" else []
    assert _ppyolo_ops(program) == sorted(want + ["fused_stem", "quantized_conv2d"])
    direct = det.predict_batch(images, sizes)
    assert (direct[..., 0] >= 0).any()
    assert np.array_equal(serving_fn(program)(images, sizes), direct)


def _run(module, *args):
    return subprocess.run([sys.executable, "-m", f"ppyolo_tpu_torch.tools.{module}", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=600)


def test_export_cli(tmp_path):
    out = str(tmp_path / "r18vd_128_b1.pt2")
    r = _run("export_serving", "--config", "1", "--out", out, "--batch", "1", "--size", "128",
             "--precision", "fp32", "--use_gpu", "false")
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"wrote {out}" in r.stdout and "batch=1, size=128" in r.stdout
    dets = load_serving_file(out)(np.zeros((1, 128, 128, 3), np.uint8),
                                  np.array([[128.0, 128.0]], np.float32))
    assert dets.shape[0] == 1 and dets.shape[2] == 6


def test_serve_artifact_cli(tmp_path):
    """Artifact-only serving: 5 readable images of odd sizes through a
    batch-2 artifact (3 calls, the last padded) and one corrupt file,
    skipped with a warning."""
    import cv2

    art = str(tmp_path / "det.pt2")
    save_serving(art, export_detector(_detector(_r18_cfg(), 128), batch=2))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    r = np.random.RandomState(0)
    for i, (h, w) in enumerate([(97, 153), (64, 64), (200, 120), (80, 140), (150, 90)]):
        cv2.imwrite(str(img_dir / f"i{i}.jpg"), r.randint(0, 255, (h, w, 3)).astype(np.uint8))
    (img_dir / "corrupt.jpg").write_bytes(b"\xff\xd8 not a real jpeg")
    out, draw = str(tmp_path / "dets.json"), str(tmp_path / "drawn")
    res = _run("serve_artifact", "--artifact", art, "--image_dir", str(img_dir), "--out", out,
               "--draw_dir", draw, "--score_thresh", "0.0", "--use_gpu", "false")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "unreadable image skipped" in res.stderr
    assert "5 images" in res.stdout
    dets = json.load(open(out))
    assert isinstance(dets, list) and dets
    for d in dets:
        assert set(d) == {"image", "label", "score", "bbox"}
        assert d["image"] != "corrupt.jpg"
    assert len(os.listdir(draw)) == 5
