"""The port's training and eval entries on the CPU, against the JAX package.

The mini-2x configuration (``test_torch_port_train.mini2x_cfg``: ResNet18-vd
with DCNv2 in stage 5 and the full ppyolo_2x head, 2 classes) trains on a
synthetic COCO set at 64 and 96 px.  Held here:

* checkpoint files cross between the packages: a JAX-written params npz
  loads into the port with head maps equal to the JAX forward (fp64 on
  both sides, within 1e-9), and the port's step npz and ``last_state.npz``
  load in ``ppyolo_tpu.checkpoint`` with every array equal;
* ``evaluate_map`` and ``detections_to_coco`` equal the JAX package's
  exactly on the same detections;
* the entry writes the JAX package's files and metrics rows, and 2 steps,
  a resume and 2 more steps equal 4 straight steps bitwise (DropBlock off,
  as ``tests/test_integration.py`` holds the JAX entry);
* ``run_eval`` returns 12 finite stats and draws; the inputs not ported
  raise ``NotImplementedError``.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.checkpoint import load_params_npz as jax_load_params_npz
from ppyolo_tpu.checkpoint import load_train_state as jax_load_train_state
from ppyolo_tpu.checkpoint import save_params_npz as jax_save_params_npz
from ppyolo_tpu.eval.coco_eval import detections_to_coco as jax_detections_to_coco
from ppyolo_tpu.eval.coco_metric import evaluate_map as jax_evaluate_map
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.module import Ctx
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten
from ppyolo_tpu.train import init_train_state as jax_init_state

from ppyolo_tpu_torch.checkpoint.bridge import state_dict_to_jax_params
from ppyolo_tpu_torch.checkpoint.io import (load_params_npz, load_train_state,
                                            save_train_state)
from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco
from ppyolo_tpu_torch.entry import eval as eval_entry
from ppyolo_tpu_torch.entry import train as train_entry
from ppyolo_tpu_torch.eval.coco_eval import coco_eval, detections_to_coco
from ppyolo_tpu_torch.eval.coco_metric import evaluate_map
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.train.train_step import init_train_state

from test_torch_port_train import mini2x_cfg

METRIC_KEYS = {"iter", "time", "loss_xy", "loss_wh", "loss_obj", "loss_cls", "loss_iou",
               "loss_iou_aware", "total_loss", "lr", "size", "step_s", "imgs_per_sec",
               "tflops", "mfu"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    anno, img_dir = make_synthetic_coco(str(root), 6, 2, np.random.RandomState(0),
                                        image_sizes=((96, 128), (128, 96)), box_range=(20, 48))
    return str(root), anno, img_dir


def entry_cfg(dataset, **train):
    root, anno, img_dir = dataset
    cfg = mini2x_cfg()
    cfg.train_path = cfg.val_path = anno
    cfg.train_pre_path = cfg.val_pre_path = img_dir
    cfg.classes_path = os.path.join(root, "no_classes.txt")
    cfg.randomShape = dict(sizes=[64, 96], random_inter=True)
    cfg.train_cfg = dict(cfg.train_cfg, **dict(dict(
        batch_size=2, max_iters=4, save_iter=2, eval_iter=4, log_iter=1, num_threads=2,
        precision="fp32", model_path=os.path.join(root, "missing.npz")), **train))
    cfg.eval_cfg = dict(cfg.eval_cfg, target_size=64, eval_batch_size=4, draw_image=True,
                        draw_thresh=0.0, model_path=os.path.join(root, "missing.npz"))
    return cfg


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """Four steps of the entry, a checkpoint every 2, an eval at step 4."""
    wdir = str(tmp_path_factory.mktemp("weights"))
    state = train_entry.run_training(entry_cfg(dataset), weights_dir=wdir, device="cpu")
    return state, wdir


def jax_tree(model):
    """A JAX param tree of the port model's values (the bridge, HWIO):
    ``jm.init`` costs ~10 s of compiles on the CPU."""
    return jax_unflatten({k: jnp.asarray(v)
                          for k, v in state_dict_to_jax_params(model.state_dict()).items()})


def _equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    va, vb = a.velocity(), b.velocity()
    for k in va:
        assert torch.equal(va[k], vb[k]), f"velocity {k}"
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), f"ema {k}"


# ---------------------------------------------------------------- checkpoints

def test_jax_written_params_load_into_the_port_with_equal_maps(tmp_path):
    cfg = mini2x_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    flat = jax_flatten(jax_tree(PPYOLO.from_config(cfg).init_parameters(
        torch.Generator().manual_seed(3))))
    r = np.random.RandomState(7)
    for k in sorted(flat):   # off-grid DCN samples
        if "conv_offset" in k:
            flat[k] = jnp.asarray((r.randn(*flat[k].shape) * 0.02).astype(np.float32))
    params = jax_unflatten(flat)
    path = str(tmp_path / "jax.npz")
    jax_save_params_npz(path, params)
    model = PPYOLO.from_config(cfg)
    model.load_state_dict(load_params_npz(path, model.state_dict(), strict=True))
    images = r.rand(2, 64, 64, 3)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        want = [np.asarray(o) for o in jax.jit(
            lambda p, x: jm.outputs(p, x, Ctx(train=False)))(p64, jnp.asarray(images))]
    got = model.double().outputs(torch.from_numpy(images).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-9


def test_port_written_files_load_in_the_jax_package(trained):
    state, wdir = trained
    cfg = mini2x_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    template = jax_tree(PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(1)))
    got = jax_flatten(jax_load_params_npz(os.path.join(wdir, "step00000004.npz"), template,
                                          strict=True))
    want = state_dict_to_jax_params(train_entry.eval_state_dict(state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    jstate = jax_load_train_state(os.path.join(wdir, "last_state.npz"),
                                  jax_init_state(jm, template, cfg))
    assert int(jstate.step) == state.step == 4
    params = state_dict_to_jax_params(state.model.state_dict())
    for k, v in jax_flatten(jstate.params).items():
        np.testing.assert_array_equal(np.asarray(v), params[k], err_msg=k)
    velocity = state_dict_to_jax_params(state.velocity())
    ema = state_dict_to_jax_params(state.ema)
    assert set(jstate.velocity) == set(velocity) and set(jstate.ema) == set(ema)
    for k in velocity:
        np.testing.assert_array_equal(np.asarray(jstate.velocity[k]), velocity[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(jstate.ema[k]), ema[k], err_msg=k)


def test_train_state_resume_skips_mismatched_shapes(tmp_path):
    """A bundle from another class count restores every leaf of the same
    shape and keeps the fresh output convs (``test_checkpoint.py:342``)."""
    def state_for(num_classes, seed):
        cfg = mini2x_cfg()
        cfg.num_classes = num_classes
        cfg.head = dict(cfg.head, num_classes=num_classes)
        model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
        return init_train_state(model, cfg)

    saved = state_for(2, 0)
    saved.step = 7
    path = str(tmp_path / "state.npz")
    save_train_state(path, saved)
    fresh = state_for(3, 1)
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    load_train_state(path, fresh)
    assert fresh.step == 7
    s, f = saved.model.state_dict(), fresh.model.state_dict()
    hits = miss = 0
    for k, v in f.items():
        if s[k].shape == v.shape:
            assert torch.equal(v, s[k]), k
            hits += 1
        else:
            assert torch.equal(v, before[k]), k
            miss += 1
    assert hits > 0 and miss > 0
    assert all(torch.equal(fresh.ema[k], saved.ema[k]) for k in fresh.ema
               if fresh.ema[k].shape == saved.ema[k].shape)


# ---------------------------------------------------------------- the metric

def test_evaluate_map_and_coco_rows_match_jax(dataset):
    """Noisy detections around the synthetic gt (plus a crowd and an
    ignored gt, more than 100 detections on one image): the COCO rows and
    all 12 stats exactly the JAX package's."""
    _, anno, _ = dataset
    with open(anno) as f:
        gt = json.load(f)
    gt["annotations"].append(dict(gt["annotations"][0], id=900, iscrowd=1))
    gt["annotations"].append(dict(gt["annotations"][1], id=901, ignore=1))
    r = np.random.RandomState(0)
    clsid2catid = {0: 1, 1: 2}
    rows, jrows = [], []
    for im in gt["images"]:
        n = 120 if im["id"] == 1 else 30
        pred = np.zeros((n, 6), np.float32)
        pred[:, 0] = r.randint(-1, 2, n)
        pred[:, 1] = r.rand(n)
        xy = r.rand(n, 2) * 80
        pred[:, 2:4] = xy
        pred[:, 4:6] = xy + r.rand(n, 2) * 50 + 1
        rows += detections_to_coco(pred, im["id"], clsid2catid)
        jrows += jax_detections_to_coco(pred, im["id"], clsid2catid)
    assert rows == jrows and len(rows) > 100
    got = evaluate_map(gt, rows, verbose=False)
    want = jax_evaluate_map(gt, jrows, verbose=False)
    assert got.shape == (12,)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the entries

def test_entry_trains_and_writes_the_jax_files(trained):
    state, wdir = trained
    assert state.step == 4
    files = set(os.listdir(wdir))
    assert {"step00000002.npz", "step00000004.npz", "last_state.npz", "metrics.jsonl",
            "best_model.npz"} <= files
    assert not any(f.endswith(".tmp.npz") for f in files)
    rows = [json.loads(line) for line in open(os.path.join(wdir, "metrics.jsonl"))]
    steps = [r for r in rows if "total_loss" in r]
    assert [r["iter"] for r in steps] == [1, 2, 3, 4]
    for r in steps:
        assert set(r) == METRIC_KEYS and np.isfinite(r["total_loss"])
        assert r["size"][0] in (64, 96) and r["tflops"] is None and r["mfu"] is None
    ev = [r for r in rows if "box_ap" in r]
    assert len(ev) == 1 and ev[0]["iter"] == 4 and {"iter", "time", "box_ap"} <= set(ev[0])
    assert len(ev[0]["stats"]) == 12 and all(-1 <= s <= 1 for s in ev[0]["stats"])
    # the step file is the EMA-applied params; loading it back is exact
    model = PPYOLO.from_config(mini2x_cfg())
    back = load_params_npz(os.path.join(wdir, "step00000004.npz"), model.state_dict(),
                           strict=True)
    for k, v in train_entry.eval_state_dict(state).items():
        assert torch.equal(back[k], v), k


def test_resume_is_bitwise_equal_to_the_uninterrupted_run(dataset, trained, tmp_path):
    """2 steps, ``resume_state``, 2 more: params, momentum and EMA equal the
    4-step run's bit for bit, so the LR and the data stream restarted from
    the restored step."""
    straight, _ = trained
    wdir = str(tmp_path / "w")
    first = train_entry.run_training(entry_cfg(dataset, max_iters=2, eval_iter=10 ** 9),
                                     weights_dir=wdir, device="cpu")
    assert first.step == 2
    resumed = train_entry.run_training(
        entry_cfg(dataset, eval_iter=10 ** 9,
                  resume_state=os.path.join(wdir, "last_state.npz")),
        weights_dir=wdir, device="cpu")
    assert resumed.step == 4
    _equal_states(straight, resumed)


def test_run_eval_returns_stats_and_draws(dataset, trained, tmp_path):
    state, wdir = trained
    cfg = entry_cfg(dataset)
    stats = eval_entry.run_eval(cfg, state_dict=train_entry.eval_state_dict(state),
                                device="cpu", result_dir=str(tmp_path / "a"))
    assert stats.shape == (12,) and np.isfinite(stats).all()
    assert len(os.listdir(tmp_path / "a" / "images")) == 6
    assert os.path.exists(tmp_path / "a" / "bbox_detections.json")
    # the same weights through eval_cfg['model_path']: the same stats
    cfg.eval_cfg = dict(cfg.eval_cfg, model_path=os.path.join(wdir, "step00000004.npz"))
    again = eval_entry.run_eval(cfg, device="cpu", result_dir=str(tmp_path / "b"))
    np.testing.assert_array_equal(again, stats)


@pytest.mark.parametrize("case", ["ndev", "orbax", "pt_weights", "eval_ndev", "eval_pt_weights",
                                  "distributed_eval", "cli_ndev"])
def test_inputs_not_ported_raise(dataset, tmp_path, case):
    cfg = entry_cfg(dataset)
    wdir = str(tmp_path)
    calls = {
        "ndev": lambda: train_entry.run_training(cfg, weights_dir=wdir, device="cpu", ndev=2),
        "orbax": lambda: train_entry.run_training(
            entry_cfg(dataset, ckpt_backend="orbax"), weights_dir=wdir, device="cpu"),
        "pt_weights": lambda: train_entry.run_training(
            entry_cfg(dataset, model_path="ppyolo_2x.pt"), weights_dir=wdir, device="cpu"),
        "eval_ndev": lambda: eval_entry.run_eval(cfg, device="cpu", ndev=2, result_dir=wdir),
        "eval_pt_weights": lambda: eval_entry.run_eval(
            _with_eval_model(cfg, "ppyolo_2x.pt"), device="cpu", result_dir=wdir),
        "distributed_eval": lambda: coco_eval(None, [], "", "", 1, result_dir=wdir,
                                              distributed=True),
        "cli_ndev": lambda: train_entry.main(["--config", "1", "--use_gpu", "false",
                                              "--ndev", "2"]),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        calls[case]()
    assert not os.path.exists(os.path.join(wdir, "metrics.jsonl"))


def _with_eval_model(cfg, path):
    cfg.eval_cfg = dict(cfg.eval_cfg, model_path=path)
    return cfg


def test_entries_default_to_the_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry.run_training(entry_cfg(dataset), weights_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_entry.run_eval(entry_cfg(dataset), result_dir=str(tmp_path))


def test_detector_set_params_and_the_per_image_api():
    """``set_params`` on a built Detector gives the detections of a Detector
    built with those weights (the periodic eval reuses one); ``detect_image``
    and ``detect_batch`` return the kept rows of ``predict_batch``."""
    from ppyolo_tpu_torch.eval.detector import Detector

    cfg = mini2x_cfg()
    sds = [PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(s)).state_dict()
           for s in (0, 1)]
    det = Detector(PPYOLO.from_config(cfg), sds[0], cfg, target_size=64, device="cpu")
    fresh = Detector(PPYOLO.from_config(cfg), sds[1], cfg, target_size=64, device="cpu")
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (90, 120, 3)).astype(np.uint8) for _ in range(2)]
    pimages, sizes = zip(*(det.process_image(im) for im in imgs))
    pimages, sizes = np.concatenate(pimages), np.concatenate(sizes)
    before = det.predict_batch(pimages, sizes)
    det.set_params(sds[1])
    got = det.predict_batch(pimages, sizes)
    np.testing.assert_array_equal(got, fresh.predict_batch(pimages, sizes))
    assert not np.array_equal(got, before)
    for (boxes, scores, classes), pred in zip(det.detect_batch(imgs), got):
        keep = pred[:, 0] >= 0
        np.testing.assert_array_equal(boxes, pred[keep, 2:6])
        np.testing.assert_array_equal(scores, pred[keep, 1])
        np.testing.assert_array_equal(classes, pred[keep, 0].astype(np.int32))
    boxes, scores, classes = det.detect_image(imgs[0], draw_thresh=0.05)
    assert boxes.shape == (len(scores), 4) and (scores >= 0.05).all()
