"""The port's small ops against the JAX package's, on the CPU.

Pooling, upsample, CoordConv, SPP, the IoU-aware decode, pairwise IoU and
batched Matrix-NMS.  Inputs come from a numpy seed; fp32 comparisons hold
at 1e-5-1e-4.  Matrix-NMS is also held on bf16 scores full of ties, where
labels and order must be exact (``lax.top_k`` breaks ties by the lowest
index, and the port's stable sort must do the same).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.ops import blocks as jb
from ppyolo_tpu.ops.iou import pairwise_iou as jax_iou
from ppyolo_tpu.ops.matrix_nms import matrix_nms as jax_nms
from ppyolo_tpu.ops.yolo_box import de_sigmoid as jax_de_sigmoid
from ppyolo_tpu.ops.yolo_box import yolo_box_serving as jax_decode

from ppyolo_tpu_torch.ops import blocks as tb
from ppyolo_tpu_torch.ops.iou import pairwise_iou
from ppyolo_tpu_torch.ops.matrix_nms import _topk, matrix_nms
from ppyolo_tpu_torch.ops.yolo_box import de_sigmoid, yolo_box_serving

NMS_CFG = dict(score_threshold=0.01, post_threshold=0.01, nms_top_k=500,
               keep_top_k=100, use_gaussian=False, gaussian_sigma=2.0)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("op", ["max3s2", "max5", "max13", "avg", "up", "coord", "spp"])
def test_blocks_match_jax(op):
    x = np.random.RandomState(0).randn(2, 13, 13, 5).astype(np.float32)
    jx, tx = jnp.asarray(x), nchw(x)
    fns = {
        "max3s2": (lambda a: jb.max_pool2d(a, 3, 2, 1), lambda t: tb.max_pool2d(t, 3, 2, 1)),
        "max5": (lambda a: jb.max_pool2d(a, 5, 1, 2), lambda t: tb.max_pool2d(t, 5, 1, 2)),
        "max13": (lambda a: jb.max_pool2d(a, 13, 1, 6), lambda t: tb.max_pool2d(t, 13, 1, 6)),
        "avg": (lambda a: jb.avg_pool2d(a, 2, 2), lambda t: tb.avg_pool2d(t, 2, 2)),
        "up": (jb.upsample_nearest_2x, tb.upsample_nearest_2x),
        "coord": (jb.coord_conv, tb.coord_conv),
        "spp": (jb.spp, tb.spp),
    }
    jf, tf = fns[op]
    want = np.asarray(jf(jx))
    got = nhwc(tf(tx))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_coord_planes_order():
    p = tb.coord_planes(3, 5, torch.float32, "cpu")
    assert p.shape == (1, 2, 3, 5)
    torch.testing.assert_close(p[0, 0, 0], torch.linspace(-1, 1, 5))   # x along W
    torch.testing.assert_close(p[0, 1, :, 0], torch.linspace(-1, 1, 3))  # y along H


def test_de_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(0, 1, 101), [1e-9, 1 - 1e-9]]).astype(np.float32)
    np.testing.assert_allclose(de_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_de_sigmoid(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("iou_aware", [True, False])
def test_yolo_box_serving_matches_jax(iou_aware):
    r = np.random.RandomState(1)
    an, nc, s = 3, 4, 5
    nf = an * (nc + 6) if iou_aware else an * (nc + 5)
    out = (r.randn(2, s, s, nf) * 2).astype(np.float32)
    anchors = np.array([[10, 13], [16, 30], [33, 23]], np.float32)
    im_size = np.array([[480, 640], [160, 160]], np.float32)
    f = 0.4 if iou_aware else None
    jb_, js = jax_decode(jnp.asarray(out), jnp.asarray(anchors), 32, nc, 1.05,
                         jnp.asarray(im_size), True, iou_aware_factor=f)
    tb_, ts = yolo_box_serving(nchw(out), torch.from_numpy(anchors), 32, nc, 1.05,
                               torch.from_numpy(im_size), True, iou_aware_factor=f)
    np.testing.assert_allclose(tb_.numpy(), np.asarray(jb_), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_pairwise_iou_matches_jax():
    r = np.random.RandomState(2)
    xy = r.rand(7, 2) * 50
    a = np.concatenate([xy, xy + r.rand(7, 2) * 30 + 1], 1).astype(np.float32)
    b = np.concatenate([a[:3], np.zeros((2, 4), np.float32)])
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), eps=1e-9))
    got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), eps=1e-9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_topk_breaks_ties_by_lowest_index():
    x = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.125, 0.75]])
    vals, idx = _topk(x, 4)
    assert idx.tolist() == [[1, 3, 5, 0]]
    assert vals.tolist() == [[0.75, 0.75, 0.75, 0.5]]


def _nms_inputs(seed, levels, nc, quant=None):
    r = np.random.RandomState(seed)
    boxes, scores = [], []
    for a in levels:
        xy = r.rand(2, a, 2) * 500
        wh = r.rand(2, a, 2) * 120 + 4
        boxes.append(np.concatenate([xy, xy + wh], -1).astype(np.float32))
        s = r.rand(2, a, nc).astype(np.float32) ** 3
        if quant:
            s = np.round(s * quant) / quant       # many exact ties
        scores.append(s)
    return boxes, scores


@pytest.mark.parametrize("levels,nc,dtype", [
    ((300, 75, 20), 4, "float32"),       # single-stage top-k (a <= 2*kanch)
    ((900, 500, 400), 3, "float32"),     # two-stage top-k over 3 levels
    ((900, 500, 400), 3, "bfloat16"),    # bf16 scores, two-stage
    ((200, 50), 6, "bfloat16"),          # bf16 scores, single-stage
])
def test_matrix_nms_matches_jax(levels, nc, dtype):
    boxes, scores = _nms_inputs(len(levels) * 10 + nc, levels, nc,
                                quant=64 if dtype == "bfloat16" else None)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    nms = jax.jit(lambda b, s: jax_nms(b, s, NMS_CFG))
    want = np.asarray(nms([jnp.asarray(b) for b in boxes],
                          [jnp.asarray(s, jdt) for s in scores]))
    got = matrix_nms([torch.from_numpy(b) for b in boxes],
                     [torch.from_numpy(s).to(tdt) for s in scores], NMS_CFG).numpy()
    assert got.shape == want.shape == (2, 100, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-6, atol=1e-4)


def test_matrix_nms_gaussian_and_empty():
    boxes, scores = _nms_inputs(3, (120,), 2)
    cfg = dict(NMS_CFG, use_gaussian=True, keep_top_k=50)
    want = np.asarray(jax.jit(lambda b, s: jax_nms(b, s, cfg))(
        jnp.asarray(boxes[0]), jnp.asarray(scores[0])))
    got = matrix_nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), cfg).numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # nothing above the threshold: all sentinel rows
    empty = matrix_nms(torch.from_numpy(boxes[0]),
                       torch.zeros_like(torch.from_numpy(scores[0])), NMS_CFG)
    assert (empty == -1).all()
