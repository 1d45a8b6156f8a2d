"""The port's ``demo`` and ``test_dev`` entries, and ``eval --precision int8``, on the CPU.

The mini-2x configuration (``test_torch_port_train.mini2x_cfg``) at 64 px
on a few synthetic COCO jpgs (``data/synthetic.py``); ``configs.get_config``
is pointed at it so each entry's ``main`` runs as a user runs it.

* ``entry.demo.main`` at fp32 and int8: every image detected and drawn into
  ``--out_dir``, the counts and fps returned; a ``.pt`` that holds no
  state dict raises (``.pt`` weights load through the converter:
  ``tests/test_torch_port_convert.py``).
* ``entry.test_dev.main`` writes the submission json of ``cfg.test_path``
  equal to the JAX package's ``eval.run_eval(type_="test_dev")`` on the same
  weights at fp32, with ``multiclass_nms``: the same rows in the same order, categories and image
  ids exact, scores within rtol 1e-3 / atol 1e-5 and boxes within 0.5 px
  (``tests/test_torch_port_model.py::assert_pred_close``, the golden
  tolerances of ``tests/test_golden.py``).
* ``entry.eval.main --precision int8`` returns 12 finite stats.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import configs
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten

from ppyolo_tpu_torch.checkpoint.bridge import state_dict_to_jax_params
from ppyolo_tpu_torch.checkpoint.io import save_params_npz
from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco
from ppyolo_tpu_torch.entry import demo as demo_entry
from ppyolo_tpu_torch.entry import eval as eval_entry
from ppyolo_tpu_torch.entry import test_dev as test_dev_entry
from ppyolo_tpu_torch.models import PPYOLO

from test_torch_port_train import mini2x_cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    anno, img_dir = make_synthetic_coco(str(root), 5, 2, np.random.RandomState(1),
                                        image_sizes=((96, 128), (128, 96)), box_range=(20, 48))
    return str(root), anno, img_dir


@pytest.fixture(scope="module")
def weights(dataset):
    """An npz of mini-2x weights (seeded, small random offset convs)."""
    root = dataset[0]
    model = PPYOLO.from_config(mini2x_cfg()).init_parameters(torch.Generator().manual_seed(2))
    sd = model.state_dict()
    r = np.random.RandomState(3)
    for k in sorted(sd):
        if "conv_offset" in k:
            sd[k] = torch.from_numpy((r.randn(*sd[k].shape) * 0.02).astype(np.float32))
    path = os.path.join(root, "weights.npz")
    save_params_npz(path, sd)
    return path, sd


def _cfg(dataset, model_path):
    root, anno, img_dir = dataset
    cfg = mini2x_cfg()
    cfg.val_path = cfg.test_path = anno
    cfg.val_pre_path = cfg.test_pre_path = img_dir
    cfg.classes_path = os.path.join(root, "no_classes.txt")
    cfg.eval_cfg = dict(cfg.eval_cfg, target_size=64, eval_batch_size=2, draw_image=False,
                        model_path=model_path)
    cfg.test_cfg = dict(cfg.test_cfg, target_size=64, draw_image=True, draw_thresh=0.0,
                        model_path=model_path)
    return cfg


@pytest.fixture
def config0(monkeypatch, dataset, weights):
    """``--config 0`` is the mini-2x configuration on the synthetic set."""
    cfg = _cfg(dataset, weights[0])
    monkeypatch.setattr(configs, "get_config", lambda index: cfg)
    return cfg


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_demo_detects_and_draws_every_image(config0, dataset, tmp_path, precision):
    out_dir = tmp_path / "res"
    got = demo_entry.main(["--config", "0", "--use_gpu", "false", "--precision", precision,
                           "--image_dir", dataset[2], "--out_dir", str(out_dir)])
    names = sorted(f for f in os.listdir(dataset[2]) if f.endswith(".jpg"))
    assert got["images"] == got["drawn"] == len(names) == 5
    assert got["fps"] > 0 and got["device_ms"] is None and got["precision"] == precision
    assert sorted(os.listdir(out_dir)) == names


def test_demo_refuses_pt_weights(dataset, tmp_path):
    bad_pt = tmp_path / "ppyolo_2x.pt"
    bad_pt.write_bytes(b"not a torch file")
    with pytest.raises(ValueError, match="not a torch state dict"):
        demo_entry.run_demo(_cfg(dataset, str(bad_pt)), dataset[2], str(tmp_path),
                            device="cpu")
    with pytest.raises(FileNotFoundError):
        demo_entry.run_demo(_cfg(dataset, "missing.npz"), str(tmp_path), str(tmp_path),
                            device="cpu")


def test_test_dev_json_equals_the_jax_entry(config0, dataset, weights, tmp_path):
    """With ``multiclass_nms``: the submission rows keep their raw scores.
    Matrix-NMS decays each score by the IoUs of its class's earlier boxes,
    and on random weights many boxes are a pixel thin, whose IoUs move by
    a few 1e-3 under fp32 rounding (two rows of 500 swapped places here);
    ``test_torch_port_model.py`` holds Matrix-NMS against JAX."""
    from eval import run_eval as jax_run_eval

    config0.nms_cfg = dict(config0.nms_cfg, nms_type="multiclass_nms", nms_threshold=0.45)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert test_dev_entry.main(["--config", "0", "--use_gpu", "false",
                                "--result_dir", str(port_dir)]) is None
    params = jax_unflatten({k: jnp.asarray(v)
                            for k, v in state_dict_to_jax_params(weights[1]).items()})
    assert jax_run_eval(config0, type_="test_dev", params=params,
                        result_dir=str(jax_dir)) is None
    got = json.load(open(port_dir / "bbox_detections.json"))
    want = json.load(open(jax_dir / "bbox_detections.json"))
    assert len(got) == len(want) > 50
    assert [(r["image_id"], r["category_id"]) for r in got] == \
        [(r["image_id"], r["category_id"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose([r["bbox"] for r in got], [r["bbox"] for r in want],
                               rtol=1e-3, atol=0.5)


def test_eval_entry_runs_int8(config0, tmp_path):
    stats = eval_entry.main(["--config", "0", "--use_gpu", "false", "--precision", "int8",
                             "--result_dir", str(tmp_path)])
    assert stats.shape == (12,) and np.isfinite(stats).all()
