"""The port's host data pipeline against the JAX package's, on the CPU.

Everything here is numpy and cv2 on both sides, run in one process with
one cv2, so the comparisons are bitwise: the native host ops, every sample
transform under the same ``RandomState`` draws, the synthetic COCO set,
record cleaning and batch sampling, the host Gt2YoloTarget, batch assembly
and the keyed, fast-forwardable ``train_batches`` stream with and without
worker threads.
"""
import copy
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from configs import PPYOLO_2x_Config
from ppyolo_tpu import native as jax_native
from ppyolo_tpu.data import coco as jax_coco
from ppyolo_tpu.data import loader as jax_loader
from ppyolo_tpu.data import synthetic as jax_synthetic
from ppyolo_tpu.data import targets as jax_targets
from ppyolo_tpu.data import transforms as jax_transforms

from ppyolo_tpu_torch import native
from ppyolo_tpu_torch.data import coco, loader, synthetic, targets, transforms

REPO = Path(__file__).resolve().parent.parent
JAX_SO = REPO / "native" / "libhost_ops.so"


def assert_same(a, b, path="sample"):
    """Bitwise equality of nested samples: dicts, lists, tuples, arrays
    (dtype and shape too) and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, a.shape, b.dtype, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def small_cfg(anno, img_dir, **train):
    """ppyolo_2x's pipeline (mixup, distort, expand, crop, flip, the
    random-interp multi-scale) at small sizes on the synthetic set."""
    cfg = PPYOLO_2x_Config()
    cfg.num_classes = 4
    cfg.gt2YoloTarget = dict(cfg.gt2YoloTarget, num_classes=4)
    cfg.train_path = cfg.val_path = anno
    cfg.train_pre_path = cfg.val_pre_path = img_dir
    cfg.randomShape = dict(sizes=[64, 96, 128], random_inter=True)
    cfg.train_cfg = dict(cfg.train_cfg, batch_size=2, mixup_epoch=2, **train)
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The same synthetic set written by both packages: (port, jax) pairs of
    (annotation path, image dir)."""
    root = tmp_path_factory.mktemp("coco")
    kw = dict(image_sizes=((96, 128), (128, 96), (112, 112)), max_objects=3, box_range=(16, 48))
    port = synthetic.make_synthetic_coco(str(root / "port"), 9, 4, np.random.RandomState(0), **kw)
    ref = jax_synthetic.make_synthetic_coco(str(root / "jax"), 9, 4, np.random.RandomState(0), **kw)
    return port, ref


def records_of(coco_mod, anno, img_dir):
    c = coco_mod.CocoJson(anno)
    catid2clsid, _, _ = coco_mod.category_maps(c)
    return coco_mod.data_clean(c, c.get_img_ids(), catid2clsid, img_dir)


# ---------------------------------------------------------------- native ops

def _settled_mtime(path: Path, quiet: float = 10.0, timeout: float = 120.0) -> int:
    """The file's mtime once nothing has written it for ``quiet`` seconds:
    in a fresh checkout the JAX package builds it lazily, possibly in
    another test process at the same time."""
    deadline = time.time() + timeout
    while time.time() - path.stat().st_mtime < quiet and time.time() < deadline:
        time.sleep(0.5)
    return path.stat().st_mtime_ns


def test_native_ops_match_the_jax_library_and_leave_its_file_alone(tmp_path, monkeypatch):
    """The port builds its own library (here from scratch, into a temporary
    build directory) and never writes the JAX package's."""
    assert jax_native.get_lib() is not None      # built (if missing) before the mtime is read
    before = _settled_mtime(JAX_SO)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    assert native.get_lib() is not None
    assert Path(native.get_lib()._name).parent == tmp_path
    assert Path(native.get_lib()._name).name.startswith("libhost_ops-")
    r = np.random.RandomState(0)
    dt = np.concatenate([r.rand(7, 2) * 50, r.rand(7, 2) * 30 + 1], 1)
    gt = np.concatenate([r.rand(5, 2) * 50, r.rand(5, 2) * 30 + 1], 1)
    crowd = np.array([0, 1, 0, 0, 1], np.uint8)
    assert_same(native.bbox_iou_xywh(dt, gt, crowd), jax_native.bbox_iou_xywh(dt, gt, crowd))
    ious = native.bbox_iou_xywh(dt, gt, crowd)
    ign = np.array([0, 1, 1, 0, 1], bool)
    thrs = np.linspace(0.05, 0.5, 10)
    assert_same(native.match_greedy(ious, ign, crowd.astype(bool), thrs),
                jax_native.match_greedy(ious, ign, crowd.astype(bool), thrs))
    u8 = r.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    f32 = (r.rand(13, 17, 3) * 300 - 20).astype(np.float32)
    codes = np.array([2, 0, 3, 1], np.int32)
    params = r.rand(4, 12).astype(np.float32)
    for img in (u8, f32):
        assert_same(native.color_distort(img, codes, params),
                    jax_native.color_distort(img, codes, params))
    other = r.randint(0, 256, (9, 21, 3)).astype(np.uint8)
    assert_same(native.mixup_u8(u8, other, 0.37), jax_native.mixup_u8(u8, other, 0.37))
    got, want = np.empty(f32.shape, np.uint8), np.empty(f32.shape, np.uint8)
    assert native.pack_u8(f32, got) and jax_native.pack_u8(f32, want)
    assert_same(got, want)
    with pytest.raises(ValueError, match="pack_u8"):
        native.pack_u8(f32.astype(np.float64), got)
    assert JAX_SO.stat().st_mtime_ns == before


def test_numpy_fallbacks_match_the_native_ops(monkeypatch):
    """Without the library every caller takes its numpy path, bitwise the
    same: the fused colour distort, mixup, the uint8 pack and the scatter."""
    r = np.random.RandomState(1)
    sample = {"image": r.randint(0, 256, (24, 20, 3)).astype(np.uint8),
              "gt_bbox": np.array([[1, 2, 10, 12]], np.float32),
              "gt_class": np.array([[1]], np.int32), "gt_score": np.ones((1, 1), np.float32),
              "h": 24, "w": 20}
    sample["mixup"] = copy.deepcopy(sample)
    sample["mixup"]["image"] = r.randint(0, 256, (16, 28, 3)).astype(np.uint8)
    ops = [transforms.MixupImage(), transforms.ColorDistort()]
    gt = (r.rand(2, 6, 4) * 0.5 + 0.05).astype(np.float32), r.randint(0, 4, (2, 6)), \
        np.ones((2, 6), np.float32)
    tcfg = PPYOLO_2x_Config().gt2YoloTarget

    def run():
        s = copy.deepcopy(sample)
        rng = np.random.RandomState(5)
        for op in ops:
            s = op(s, rng)
        out = np.empty(s["image"].shape, np.uint8)
        packed = native.pack_u8(np.ascontiguousarray(s["image"]), out)
        return s, out if packed else None, targets.gt2yolo_targets(
            *gt, (64, 64), tcfg["anchors"], tcfg["anchor_masks"], [32, 16, 8], 4)

    with_lib = run()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", True)
    without = run()
    assert native.color_distort(sample["image"], np.zeros(1, np.int32),
                                np.zeros((1, 12), np.float32)) is None
    assert without[1] is None and with_lib[1] is not None
    assert_same(with_lib[0], without[0])
    assert_same(with_lib[2], without[2])
    img = without[0]["image"]
    np.testing.assert_array_equal(with_lib[1], np.clip(np.rint(img), 0, 255).astype(np.uint8))


# ---------------------------------------------------------------- COCO records

def test_synthetic_set_records_and_samples_match_jax(dataset):
    (anno, img_dir), (janno, jimg_dir) = dataset
    assert Path(anno).read_text() == Path(janno).read_text()
    for f in sorted(Path(jimg_dir).iterdir()):
        assert (Path(img_dir) / f.name).read_bytes() == f.read_bytes(), f.name
    recs = records_of(coco, anno, img_dir)
    jrecs = records_of(jax_coco, janno, jimg_dir)
    for rec in jrecs:
        rec["im_file"] = rec["im_file"].replace(jimg_dir, img_dir)
    assert_same(recs, jrecs)
    c, jc = coco.CocoJson(anno), jax_coco.CocoJson(janno)
    assert coco.category_maps(c) == jax_coco.category_maps(jc)
    idx = np.random.RandomState(3).permutation(len(recs))
    for step in range(3):
        got = coco.get_samples(recs, idx, step, 3, step + 1, True, True, 2, 2,
                               np.random.RandomState(step))
        want = jax_coco.get_samples(recs, idx, step, 3, step + 1, True, True, 2, 2,
                                    np.random.RandomState(step))
        assert_same(got, want)


# ---------------------------------------------------------------- transforms

def _decoded(recs, i, partner=None):
    s = copy.deepcopy(recs[i])
    if partner is not None:
        s[partner] = copy.deepcopy(recs[(i + 1) % len(recs)])
    return transforms.DecodeImage(with_mixup=True, with_cutmix=True)(s, None)


def _float_image(s):
    s["image"] = s["image"].astype(np.float32) * np.float32(0.93) + np.float32(3.3)
    return s


CASES = {
    # name: (port op, jax op, partner key, float input image)
    "decodeImage": ("DecodeImage", dict(with_mixup=True), "mixup", False),
    "mixupImage": ("MixupImage", {}, "mixup", False),
    "cutmixImage": ("CutmixImage", {}, "cutmix", False),
    "photometricDistort": ("PhotometricDistort", {}, None, False),
    "colorDistort": ("ColorDistort", {}, None, False),
    "colorDistort_f32": ("ColorDistort", {}, None, True),
    "randomExpand": ("RandomExpand", dict(fill_value=[123.675, 116.28, 103.53]), None, False),
    "randomCrop": ("RandomCrop", {}, None, False),
    "randomFlipImage": ("RandomFlipImage", {}, None, False),
    "normalizeBox": ("NormalizeBox", {}, None, False),
    "padBox": ("PadBox", dict(num_max_boxes=50), None, False),
    "bboxXYXY2XYWH": ("BboxXYXY2XYWH", {}, None, False),
    "normalizeImage": ("NormalizeImage", dict(mean=[0.485, 0.456, 0.406],
                                              std=[0.229, 0.224, 0.225]), None, False),
    "permute_bgr": ("Permute", dict(to_bgr=True), None, True),
    "resizeImage": ("ResizeImage", dict(target_size=[64, 80], interp=2), None, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_each_transform_matches_jax(dataset, name):
    """Six seeds a transform, on decoded samples (with a partner where it
    takes one): the output sample and the rng's state after it."""
    (anno, img_dir), _ = dataset
    recs = records_of(coco, anno, img_dir)
    cls_name, kwargs, partner, as_float = CASES[name]
    op = getattr(transforms, cls_name)(**kwargs)
    jop = getattr(jax_transforms, cls_name)(**kwargs)
    for seed in range(6):
        if cls_name == "DecodeImage":
            s = copy.deepcopy(recs[seed])
            s["mixup"] = copy.deepcopy(recs[seed + 1])
        else:
            s = _decoded(recs, seed, partner)
        if as_float:
            s = _float_image(s)
        if cls_name == "BboxXYXY2XYWH":
            s = transforms.NormalizeBox()(s, None)
        r, jr = np.random.RandomState(seed), np.random.RandomState(seed)
        got = op(copy.deepcopy(s), r)
        want = jop(copy.deepcopy(s), jr)
        assert_same(got, want)
        assert_same(r.get_state()[1], jr.get_state()[1], "rng state")


@pytest.mark.parametrize("with_dst", [False, True])
def test_random_shape_matches_jax(dataset, with_dst):
    """The batch resize with random interpolation and box rescale, into a
    reused scratch (``dst=``) or not, and the batch-level RandomShape."""
    (anno, img_dir), _ = dataset
    recs = records_of(coco, anno, img_dir)
    op = transforms.RandomShapeSingle(random_inter=True, resize_box=True)
    jop = jax_transforms.RandomShapeSingle(random_inter=True, resize_box=True)
    for seed in range(6):
        s = _float_image(_decoded(recs, seed))
        r, jr = np.random.RandomState(seed), np.random.RandomState(seed)
        dst = np.empty((96, 96, 3), np.float32) if with_dst else None
        jdst = np.empty((96, 96, 3), np.float32) if with_dst else None
        assert_same(op(96, copy.deepcopy(s), r, dst=dst), jop(96, copy.deepcopy(s), jr, dst=jdst))
    samples = [_decoded(recs, i) for i in range(3)]
    got = transforms.RandomShape(sizes=[64, 96], random_inter=True)(
        copy.deepcopy(samples), np.random.RandomState(9))
    want = jax_transforms.RandomShape(sizes=[64, 96], random_inter=True)(
        copy.deepcopy(samples), np.random.RandomState(9))
    assert_same(got, want)


# ---------------------------------------------------------------- targets, batches

@pytest.mark.parametrize("iou_thresh", [1.0, 0.3])
@pytest.mark.parametrize("use_native", [True, False])
def test_host_targets_match_jax(iou_thresh, use_native):
    r = np.random.RandomState(2)
    b, m = 3, 12
    gt_bbox = np.zeros((b, m, 4), np.float32)
    gt_bbox[:, :9, :2] = r.uniform(0.05, 0.95, (b, 9, 2))
    gt_bbox[:, :9, 2:] = r.uniform(0.02, 0.6, (b, 9, 2))
    gt_bbox[:, 1] = gt_bbox[:, 0]                    # a collision: the later gt wins
    gt_class = r.randint(0, 5, (b, m)).astype(np.int32)
    gt_score = np.zeros((b, m), np.float32)
    gt_score[:, :9] = r.uniform(0.3, 1.0, (b, 9))
    cfg = PPYOLO_2x_Config()
    args = ((gt_bbox, gt_class, gt_score, (96, 128), cfg.head["anchors"],
             cfg.head["anchor_masks"], [32, 16, 8], 5))
    got = targets.gt2yolo_targets(*args, iou_thresh=iou_thresh, use_native=use_native)
    want = jax_targets.gt2yolo_targets(*args, iou_thresh=iou_thresh, use_native=use_native)
    assert_same(got, want)
    assert max(float(t[..., 6:].sum(-1).max()) for t in got) >= 2.0


@pytest.mark.parametrize("train", [dict(), dict(device_normalize=False, device_targets=False)])
def test_assemble_batch_matches_jax(dataset, train):
    """The uint8 path (resize into the scratch, the native pack) and the
    host-normalized path with host targets."""
    (anno, img_dir), _ = dataset
    cfg = small_cfg(anno, img_dir, **train)
    recs = records_of(coco, anno, img_dir)
    ops = loader.build_sample_transforms(cfg)
    samples = [loader.apply_sample_transforms(_decoded(recs, i, "mixup"), ops,
                                              np.random.RandomState(i)) for i in range(3)]
    timings = {}
    got = loader.assemble_batch(copy.deepcopy(samples), cfg, np.random.RandomState(4),
                                timings=timings)
    want = jax_loader.assemble_batch(copy.deepcopy(samples), cfg, np.random.RandomState(4))
    assert_same(got, want)
    assert ("targets" in got) == (not train.get("device_targets", True))
    assert got["image"].dtype == (np.uint8 if not train else np.float32)
    assert set(timings) == ({"resize_s", "pack_s"} if not train else set())


@pytest.mark.parametrize("num_threads", [1, 3])
@pytest.mark.parametrize("start_iter", [0, 3])
def test_train_batches_match_jax(dataset, start_iter, num_threads):
    """Six batches of the infinite stream, every key bitwise, from the start
    and fast-forwarded, serial and on worker threads (9 records at batch 2:
    the stream crosses epochs); the port's stream also equals its own
    uninterrupted stream at the same iters."""
    (anno, img_dir), _ = dataset
    cfg = small_cfg(anno, img_dir, num_threads=num_threads)
    recs = records_of(coco, anno, img_dir)
    gen = loader.train_batches(recs, cfg, seed=0, start_iter=start_iter)
    jgen = jax_loader.train_batches(recs, cfg, seed=0, start_iter=start_iter)
    got = [next(gen) for _ in range(6)]
    gen.close()
    assert_same(got, [next(jgen) for _ in range(6)])
    assert len({b["shape"] for b in got}) > 1
    if start_iter:
        full = loader.train_batches(recs, cfg, seed=0)
        assert_same([next(full) for _ in range(start_iter + 6)][start_iter:], got)
        full.close()


# ---------------------------------------------------------------- prefetchers

def test_prefetcher_relays_producer_errors():
    def produce():
        yield 1
        yield 2
        raise OSError("imread failed")

    pf = loader.Prefetcher(produce())
    assert [next(pf), next(pf)] == [1, 2]
    with pytest.raises(RuntimeError, match="producer") as info:
        next(pf)
    assert isinstance(info.value.__cause__, OSError)
    pf.close()


def test_prefetcher_close_stops_an_infinite_producer_and_its_pool(dataset):
    """Closing the prefetcher over ``train_batches`` on worker threads ends
    the producer thread and shuts the generator's pool down."""
    (anno, img_dir), _ = dataset
    cfg = small_cfg(anno, img_dir, num_threads=3)
    before = set(threading.enumerate())
    with loader.Prefetcher(loader.train_batches(records_of(coco, anno, img_dir), cfg),
                           max_batch=2) as pf:
        first = next(pf)
    assert first["image"].shape[0] == 2
    left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert left == []
    with pytest.raises(StopIteration):
        next(pf)


def test_device_prefetcher_on_the_cpu_passes_arrays_through():
    r = np.random.RandomState(0)
    host = [{"image": r.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             "gt_bbox": r.rand(2, 50, 4).astype(np.float32), "shape": 32,
             "targets": (r.rand(2, 1, 1, 3, 8).astype(np.float32),)} for _ in range(3)]
    got = list(loader.DevicePrefetcher(iter(host), torch.device("cpu")))
    assert len(got) == 3
    for (dev, h), want in zip(got, host):
        assert h is want and set(dev) == {"image", "gt_bbox", "targets"}
        np.testing.assert_array_equal(dev["image"].numpy(), want["image"])
        np.testing.assert_array_equal(dev["targets"][0].numpy(), want["targets"][0])
