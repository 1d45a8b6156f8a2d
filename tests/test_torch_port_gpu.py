"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  Imports torch and numpy only (no JAX), so it runs on the
GPU machine: ``python -m pytest tests/test_torch_port_gpu.py -m gpu``.
Tolerance: max-abs error <= 2% of the plain output's max-abs (bf16 operands).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppyolo_tpu_torch.ops.deform_conv import dcn_bwd_plain, deform_conv2d, deform_conv2d_plain
from ppyolo_tpu_torch.ops.stem import fused_stem, fused_stem_plain


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _dcn_inputs(seed, n, h, w, c, oc, stride):
    r = np.random.RandomState(seed)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = r.randn(n, h, w, c).astype(np.float32)
    wt = (r.randn(oc, c, 3, 3) * 0.1).astype(np.float32)
    off = (r.randn(n, oh, ow, 18) * 2.0).astype(np.float32)
    off[..., 0, 0, 0] = 3.0 * h           # far out of range
    off[..., -1, -1, 2] = float(h)        # on the clamp edge
    msk = r.randn(n, oh, ow, 9).astype(np.float32)
    return x, wt, np.concatenate([off, msk], axis=-1)


def _stem_args(seed, dtype, dev):
    r = np.random.RandomState(seed)
    out = []
    for cin, cout, s in ((3, 32, 0.3), (32, 32, 0.1), (32, 64, 0.1)):
        out.append(torch.from_numpy((r.randn(cout, cin, 3, 3) * s).astype(np.float32))
                   .to(dev, dtype))
        out.append(torch.from_numpy((r.randn(cout) * 0.1).astype(np.float32)).to(dev))
    return out


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 9, 9, 32, 64, 1), (1, 38, 38, 64, 128, 2),
                                   (3, 13, 17, 96, 64, 1), (3, 11, 7, 64, 128, 1),
                                   (1, 19, 19, 96, 192, 1), (2, 20, 20, 32, 320, 2),
                                   (8, 38, 38, 512, 512, 2), (8, 19, 19, 512, 512, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_kernel_matches_plain(shape, dtype):
    """K1 at the edges of its 64-pixel x 256-column tile and 64-channel
    k-step: ragged pixel tiles (81, 231, 800 pixels), outC = 64, 192 and 320
    (a consumer warpgroup half or wholly past outC), C = 32 and 96 (a
    half-empty k-step), and the stage-5 shapes at b8."""
    dev = _cuda_or_skip()
    n, h, w, c, oc, stride = shape
    x, wt, om = _dcn_inputs(3, n, h, w, c, oc, stride)
    xt = _nchw(x, dtype).to(dev)
    wtt = torch.from_numpy(wt).to(dev)
    om = _nchw(om, dtype).to(dev)
    want = deform_conv2d_plain(xt, wtt, om, stride=stride, padding=1).float()
    got = deform_conv2d(xt, wtt, om, stride=stride, padding=1)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want).abs().max() <= 0.02 * want.abs().max()


@pytest.mark.gpu
def test_dcn_kernel_deterministic_and_layout_checked():
    """Two calls of K1 on one input give the same bits (no atomics, one
    order of sums), a bias is added in fp32, and a weight in the old
    [k2*C, outC] layout raises."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd, pack_dcn_weight

    dev = _cuda_or_skip()
    x, wt, om = _dcn_inputs(8, 2, 19, 19, 512, 512, 1)
    xt = _nchw(x, torch.bfloat16).to(dev).contiguous(memory_format=torch.channels_last)
    om = _nchw(om, torch.bfloat16).to(dev).contiguous(memory_format=torch.channels_last)
    packed = pack_dcn_weight(torch.from_numpy(wt).to(dev))
    kw = dict(ksize=(3, 3), stride=1, padding=1)
    a = dcn_fwd(xt, om, packed, None, **kw)
    assert torch.equal(a, dcn_fwd(xt, om, packed, None, **kw))
    bias = torch.linspace(-1, 1, 512, device=dev)
    want = deform_conv2d_plain(xt, torch.from_numpy(wt).to(dev), om, stride=1, padding=1,
                               bias=bias).float()
    got = dcn_fwd(xt, om, packed, bias, **kw).float()
    assert (got - want).abs().max() <= 0.02 * want.abs().max()
    with pytest.raises(ValueError, match="pack_dcn_weight"):
        dcn_fwd(xt, om, packed.t().contiguous(), None, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("size,batch", [(64, 2), (70, 1), (608, 1), (600, 1), (416, 2),
                                        (45, 3), (608, 8)])
def test_stem_kernel_matches_plain(size, batch):
    """600, 416, 70 and 45 leave ragged strips, segments and pooled tiles;
    a row of 70 or 45 pixels starts off a 16-byte boundary."""
    dev = _cuda_or_skip()
    x = np.random.RandomState(4).randn(batch, size, size, 3).astype(np.float32)
    xt = _nchw(x, torch.bfloat16).to(dev)
    args = _stem_args(size, torch.bfloat16, dev)
    want = fused_stem_plain(xt, *args).float()
    got = fused_stem(xt, *args)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got.float() - want).abs().max() <= 0.02 * want.abs().max()


@pytest.mark.gpu
def test_stem_kernel_packed_once_and_deterministic():
    """Parameters packed once give the bits of the call that packs them, and
    two calls on one input give the same bits (no atomics)."""
    from ppyolo_tpu_torch.ops.stem import pack_stem_params

    dev = _cuda_or_skip()
    x = np.random.RandomState(5).randn(2, 600, 600, 3).astype(np.float32)
    xt = _nchw(x, torch.bfloat16).to(dev)
    args = _stem_args(11, torch.bfloat16, dev)
    packed = pack_stem_params(*args)
    a = fused_stem(xt, *args, packed=packed)
    assert torch.equal(a, fused_stem(xt, *args, packed=packed))
    assert torch.equal(a, fused_stem(xt, *args))
    with pytest.raises(ValueError, match="pack_stem_params"):
        fused_stem(xt, *args, packed=(packed[0], packed[1].t().contiguous()) + packed[2:])


def _bwd_inputs(seed, n, h, w, c, oc, stride, dtype, dev):
    """x, OIHW weight, om (with clamp-edge taps) and an output gradient, on
    the card in the layer dtype (channels_last)."""
    x, wt, om = _dcn_inputs(seed, n, h, w, c, oc, stride)
    oh, ow = om.shape[1:3]
    om[:, 0, :, 3] = -1.0 - np.arange(ow) * stride        # raw x exactly -padding
    g = np.random.RandomState(seed + 1).randn(n, oh, ow, oc).astype(np.float32)
    cl = torch.channels_last
    return (_nchw(x, dtype).to(dev).contiguous(memory_format=cl), torch.from_numpy(wt).to(dev),
            _nchw(om, dtype).to(dev).contiguous(memory_format=cl),
            _nchw(g, dtype).to(dev).contiguous(memory_format=cl))


def _close(got, want):
    return float((got.float() - want.float()).abs().max()) <= 0.02 * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 9, 9, 32, 64, 1), (1, 38, 38, 64, 128, 2),
                                   (3, 13, 17, 96, 64, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_backward_kernel_matches_plain(shape, dtype):
    """K3 (inside dcn_backward) against dcn_bwd_plain on the same inputs:
    dx, dW and d_om within 2% of each one's max-abs (fp32 atomics sum in
    another order)."""
    from ppyolo_tpu_torch.ops.deform_conv import dcn_backward
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd

    dev = _cuda_or_skip()
    n, h, w, c, oc, stride = shape
    x, wt, om, g = _bwd_inputs(5, n, h, w, c, oc, stride, dtype, dev)
    before = dcn_bwd.launches
    got = dcn_backward(x, wt, om, g, stride=stride, padding=1)
    assert dcn_bwd.launches == before + 1
    want = dcn_backward(x, wt, om, g, stride=stride, padding=1, plain=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dW", "d_om"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all() and _close(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", ["near", "far", "mixed"])
@pytest.mark.parametrize("shape", [(8, 38, 38, 512, 512, 2), (8, 19, 19, 512, 512, 1),
                                   (2, 13, 17, 96, 64, 1), (1, 9, 9, 40, 64, 2)])
def test_dcn_backward_kernel_bins(shape, offsets):
    """K3 against dcn_bwd_plain with offsets within a pixel (every corner
    binned near its tap), offsets of 4 to 3H rows (clamped onto the image's
    edges and corners: bins far past their capacity, so the overflow list),
    and both; at the stage-5 shapes and with C = 96 and 40 (a ragged
    256-channel step)."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd

    dev = _cuda_or_skip()
    n, h, w, c, oc, stride = shape
    x, wt, om, g = _bwd_inputs(12, n, h, w, c, oc, stride, torch.bfloat16, dev)
    r = np.random.RandomState(13)
    oh, ow = om.shape[2:]
    far = r.choice([-1.0, 1.0], (n, 18, oh, ow)) * r.uniform(4.0, 3.0 * h, (n, 18, oh, ow))
    near = r.uniform(-0.99, 0.99, (n, 18, oh, ow))
    off = {"near": near, "far": far,
           "mixed": np.where(r.rand(n, 18, oh, ow) < 0.5, near, far)}[offsets]
    om = om.clone()
    om[:, :18] = torch.from_numpy(off).to(dev, om.dtype)
    dm = (g.permute(0, 2, 3, 1).reshape(-1, oc).float()
          @ wt.permute(0, 2, 3, 1).reshape(oc, -1)).to(torch.bfloat16)
    got = dcn_bwd(x, om, dm, ksize=(3, 3), stride=stride, padding=1)
    want = dcn_bwd_plain(x, om, dm, ksize=(3, 3), stride=stride, padding=1)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "d_om", "cols"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all() and _close(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", ["near", "far"])
def test_dcn_backward_kernel_is_deterministic(offsets):
    """K3 twice on the same inputs at stage5_1's shape (b8, 19x19, C 512):
    dx, d_om and cols the same bits (the dx sum runs in item order, not in
    the order atomics hand out places), with offsets near their taps and
    clamped far onto the edges (thousands of corners on one dx pixel)."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd

    dev = _cuda_or_skip()
    x, wt, om, g = _bwd_inputs(14, 8, 19, 19, 512, 512, 1, torch.bfloat16, dev)
    r = np.random.RandomState(15)
    shape = (8, 18, 19, 19)
    off = (r.uniform(-0.99, 0.99, shape) if offsets == "near"
           else r.choice([-1.0, 1.0], shape) * r.uniform(4.0, 57.0, shape))
    om = om.clone()
    om[:, :18] = torch.from_numpy(off).to(dev, om.dtype)
    dm = (g.permute(0, 2, 3, 1).reshape(-1, 512).float()
          @ wt.permute(0, 2, 3, 1).reshape(512, -1)).to(torch.bfloat16)
    first = dcn_bwd(x, om, dm, ksize=(3, 3), stride=1, padding=1)
    for _ in range(3):
        again = dcn_bwd(x, om, dm, ksize=(3, 3), stride=1, padding=1)
        for name, a, b in zip(("dx", "d_om", "cols"), again, first):
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_function_grads_match_autograd_of_plain(stride):
    """The card's DCN under autograd (K1 forward, K3 backward) against
    autograd of deform_conv2d_plain, fp32 with TF32 off: the kernels round
    their operands to bf16, so 2% of each gradient's max-abs."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd

    dev = _cuda_or_skip()
    x, wt, om, g = _bwd_inputs(9, 2, 19, 19, 64, 64, stride, torch.float32, dev)
    leaves = [t.detach().clone().requires_grad_() for t in (x, wt, om)]
    f0, b0 = dcn_fwd.launches, dcn_bwd.launches
    y = deform_conv2d(*leaves, stride=stride, padding=1)
    got = torch.autograd.grad(y, leaves, g)
    assert (dcn_fwd.launches - f0, dcn_bwd.launches - b0) == (1, 1)
    ref = [t.detach().clone().requires_grad_() for t in (x, wt, om)]
    want = torch.autograd.grad(deform_conv2d_plain(*ref, stride=stride, padding=1), ref, g)
    for name, a, b in zip(("x", "weight", "om"), got, want):
        assert a is not None and a.shape == b.shape, name
        assert _close(a, b), name


def _conv_s2_inputs(seed, n, h, c, co, dtype, dev):
    r = np.random.RandomState(seed)
    x = r.randn(n, h, h, c).astype(np.float32)
    w = (r.randn(co, c, 3, 3) * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    return _nchw(x, dtype).to(dev), torch.from_numpy(w).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 24, 16, 32), (1, 10, 24, 40), (2, 152, 128, 128),
                                   (2, 76, 256, 256), (8, 152, 128, 128), (8, 76, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_s2_kernel_matches_plain(shape, dtype):
    """K4 against conv_s2_phase: C = 16 fills a quarter of the bf16
    kernel's 64-deep chunk; (1,10,10,24->40) leaves a ragged tail of output
    pixels and of output channels; the last four are the probe's stage3_0
    and stage4_0 convs at batch 2 and 8."""
    from ppyolo_tpu_torch.ops.strided_conv import conv_s2, conv_s2_phase

    dev = _cuda_or_skip()
    n, h, c, co = shape
    x, w = _conv_s2_inputs(6, n, h, c, co, dtype, dev)
    before = conv_s2.launches
    got = conv_s2(x, w)
    assert conv_s2.launches == before + 1
    want = conv_s2_phase(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape == (n, co, h // 2, h // 2)
    assert _close(got, want)
    # the padded border: row 0 and column 0 on their own
    assert _close(got[:, :, 0], want[:, :, 0]) and _close(got[:, :, :, 0], want[:, :, :, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 10, 24, 40), (8, 76, 256, 256)])
def test_conv_s2_kernel_packed_once_and_deterministic(shape):
    """A weight packed once by the caller gives the bits of the call that
    packs it, and two calls on one input give the same bits (no atomics)."""
    from ppyolo_tpu_torch.ops.strided_conv import conv_s2, pack_conv_s2_weight

    dev = _cuda_or_skip()
    n, h, c, co = shape
    x, w = _conv_s2_inputs(10, n, h, c, co, torch.bfloat16, dev)
    packed = pack_conv_s2_weight(w)
    a = conv_s2(x, w, packed=packed)
    assert torch.equal(a, conv_s2(x, w, packed=packed))
    assert torch.equal(a, conv_s2(x, w))
    with pytest.raises(ValueError, match="pack_conv_s2_weight"):
        conv_s2(x, w, packed=packed.t().contiguous())


@pytest.mark.gpu
def test_conv_s2_kernel_layout_grad_and_channel_checks():
    from ppyolo_tpu_torch.ops.strided_conv import conv_s2

    dev = _cuda_or_skip()
    x, w = _conv_s2_inputs(7, 2, 24, 16, 32, torch.bfloat16, dev)
    assert x.is_contiguous(memory_format=torch.channels_last)
    # an NCHW-contiguous input is made channels_last before the kernel reads it
    assert torch.equal(conv_s2(x.contiguous(), w), conv_s2(x, w))
    with pytest.raises(RuntimeError, match="no backward"):
        conv_s2(x.detach().clone().requires_grad_(), w)
    xc, wc = _conv_s2_inputs(8, 1, 8, 12, 16, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        conv_s2(xc, wc)


# ---------------------------------------------------------------- the entry slice

def _host_batch(seed, n=2, size=96):
    r = np.random.RandomState(seed)
    return {"image": r.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            "gt_bbox": r.rand(n, 50, 4).astype(np.float32),
            "gt_class": r.randint(0, 80, (n, 50)).astype(np.int32),
            "gt_score": r.rand(n, 50).astype(np.float32), "shape": size,
            "targets": (r.rand(n, 3, 3, 3, 86).astype(np.float32),)}


@pytest.mark.gpu
def test_pinned_prefetcher_batches_equal_a_plain_copy():
    """Each device batch of the side-stream pinned prefetcher equals a
    plain ``.to(device)`` of its host batch, bit for bit, while the current
    stream runs work between the hand-overs."""
    from ppyolo_tpu_torch.data.loader import DevicePrefetcher

    dev = _cuda_or_skip()
    host = [_host_batch(i) for i in range(4)]
    n = 0
    for (got, h), want in zip(DevicePrefetcher(iter(host), dev), host):
        assert h is want
        busy = torch.randn(2048, 2048, device=dev)
        busy = busy @ busy   # work on the current stream while the next copy runs
        for k in ("image", "gt_bbox", "gt_class", "gt_score"):
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k], torch.from_numpy(want[k]).to(dev)), k
        assert torch.equal(got["targets"][0], torch.from_numpy(want["targets"][0]).to(dev))
        n += 1
    assert n == 4


def _predict_as_before(det, cfg, pimages, sizes):
    """``Detector.predict_batch`` as it ran before the anchors became a
    device buffer and the batch went through pinned memory: a pageable
    upload and per-level float anchors from the host."""
    from ppyolo_tpu_torch.ops.matrix_nms import matrix_nms
    from ppyolo_tpu_torch.ops.yolo_box import yolo_box_serving

    head = det.model.head
    anchors = np.asarray(cfg.head["anchors"], np.float32)
    with torch.no_grad():
        x = det.normalize(torch.from_numpy(pimages).to(det.device))
        s = torch.from_numpy(sizes).to(det.device)
        boxes, scores = [], []
        for i, out in enumerate(head.get_outputs(det.model.backbone(x))):
            b, sc = yolo_box_serving(
                out, torch.from_numpy(anchors[head.anchor_masks[i]]), head.downsample[i],
                head.num_classes, head.scale_x_y, s, head.clip_bbox,
                iou_aware_factor=head.iou_aware_factor if head.iou_aware else None)
            boxes.append(b)
            scores.append(sc)
        return matrix_nms(boxes, scores, head.nms_cfg).cpu().numpy()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_detector_predict_batch_equals_the_route_before_the_repairs(device):
    """Detections bit-equal to the earlier route, on two batches in a row,
    and no anchor leaves the model's state dict."""
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    dev = _cuda_or_skip() if device == "cuda" else torch.device("cpu")
    cfg = PPYOLO_2x_Config()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    assert not any("anchor" in k for k in model.state_dict())
    det = Detector(model, model.state_dict(), cfg, precision="bf16" if device == "cuda" else "fp32",
                   device=dev)
    assert det.model.head.mask_anchors_wh.dtype == torch.int32
    assert det.model.head.mask_anchors_wh.device.type == dev.type
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    for seed in (1, 2):
        pimages = np.random.RandomState(seed).randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
        got = det.predict_batch(pimages, sizes)
        want = _predict_as_before(det, cfg, pimages, sizes)
        assert got.shape == (2, 100, 6) and (got[..., 0] >= 0).any()
        np.testing.assert_array_equal(got, want)


def _mini2x_cfg():
    """ppyolo_2x's feature set at ResNet18-vd depth, 2 classes (the CPU
    tests' ``mini2x_cfg``, restated here without JAX)."""
    from configs import PPYOLO_2x_Config

    cfg = PPYOLO_2x_Config()
    cfg.num_classes = 2
    cfg.backbone_type = "Resnet18Vd"
    cfg.backbone = dict(norm_type="bn", feature_maps=[3, 4, 5], dcn_v2_stages=[5],
                        freeze_at=0, freeze_norm=False, norm_decay=0.0)
    cfg.head = dict(cfg.head, num_classes=2, in_channels=[512, 256, 128])
    cfg.gt2YoloTarget = dict(cfg.gt2YoloTarget, num_classes=2)
    return cfg


@pytest.mark.gpu
def test_entry_two_steps_on_the_card_with_launch_counts(tmp_path):
    """Two bf16 steps of the training entry at 96 px on a synthetic COCO
    set, a checkpoint and an eval at step 2.  The steps and the eval
    batches are CUDA graph replays, each graph captured after one eager
    warm-up run, and the counters count launches, the replays' included:
    every DCN launches K1 and K3 three times for the one training size (the
    warm-up run and 2 steps) and K1 three times, as K2, for the eval of
    the 4 images in batches of 2 (the warm-up run and 2 batches); one call
    of each is recorded per graph."""
    import json

    from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco
    from ppyolo_tpu_torch.entry.train import run_training
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.conv import ConvNormAct
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd
    from ppyolo_tpu_torch.ops.stem import fused_stem

    _cuda_or_skip()
    anno, img_dir = make_synthetic_coco(str(tmp_path / "coco"), 4, 2, np.random.RandomState(0),
                                        image_sizes=((96, 128), (128, 96)), box_range=(20, 48))
    cfg = _mini2x_cfg()
    cfg.train_path = cfg.val_path = anno
    cfg.train_pre_path = cfg.val_pre_path = img_dir
    cfg.randomShape = dict(sizes=[96], random_inter=True)
    cfg.train_cfg = dict(cfg.train_cfg, batch_size=2, max_iters=2, save_iter=2, eval_iter=2,
                         log_iter=1, precision="bf16", model_path=str(tmp_path / "missing.npz"))
    cfg.eval_cfg = dict(cfg.eval_cfg, target_size=96, eval_batch_size=2)
    n_dcn = sum(m.use_dcn for m in PPYOLO.from_config(cfg).modules() if isinstance(m, ConvNormAct))
    assert n_dcn > 0
    wrappers = (dcn_fwd, dcn_bwd, fused_stem)
    counts = [(f.launches, f.captured) for f in wrappers]
    state = run_training(cfg, weights_dir=str(tmp_path / "w"))
    torch.cuda.synchronize()
    got = [(f.launches - a, f.captured - b) for f, (a, b) in zip(wrappers, counts)]
    assert state.step == 2
    assert got == [(3 * n_dcn + 3 * n_dcn, n_dcn + n_dcn), (3 * n_dcn, n_dcn), (3, 1)]
    rows = [json.loads(line) for line in open(tmp_path / "w" / "metrics.jsonl")]
    assert [r["iter"] for r in rows if "total_loss" in r] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r)
    assert os.path.exists(tmp_path / "w" / "last_state.npz")


def _gpu_batch(seed, batch, size, num_classes=2, n_gt=4):
    r = np.random.RandomState(seed)
    gt_bbox = np.zeros((batch, 50, 4), np.float32)
    gt_bbox[:, :n_gt, :2] = r.uniform(0.2, 0.8, (batch, n_gt, 2))
    gt_bbox[:, :n_gt, 2:] = r.uniform(0.05, 0.5, (batch, n_gt, 2))
    gt_score = np.zeros((batch, 50), np.float32)
    gt_score[:, :n_gt] = 1.0
    b = {"image": r.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
         "gt_bbox": gt_bbox, "gt_class": r.randint(0, num_classes, (batch, 50)).astype(np.int32),
         "gt_score": gt_score}
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def _train_setup(seed=0):
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    cfg = _mini2x_cfg()
    cfg.head = dict(cfg.head, drop_block=True)
    cfg.use_ema = True
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
    model.to(device="cuda", memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, compute_dtype=torch.bfloat16)
    return cfg, model, state, step, torch.Generator(device="cuda").manual_seed(3)


@pytest.mark.gpu
def test_graphed_train_steps_are_bitwise_the_eager_steps():
    """Three bf16 steps (K1 and K3 inside, DropBlock on) replayed from a
    CUDA graph equal three eager steps from the same state and generator,
    bit for bit: losses, params, BN statistics, momentum, EMA, the step and
    the generator; the counters count the warm-up run's launches and each
    replay's, and the capture's calls apart."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd
    from ppyolo_tpu_torch.train.graphs import WARMUP_ITERS, GraphedStep

    _cuda_or_skip()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    batches = [_gpu_batch(40 + i, 2, 96) for i in range(3)]
    _, _, eager, step, gen_e = _train_setup()
    want = []
    for b in batches:
        _, losses = step(eager, b, gen_e)
        want.append({k: v.clone() for k, v in losses.items()})
    _, _, graphed, step_g, gen_g = _train_setup()
    unit = GraphedStep(step_g, graphed, gen_g)
    counts = [(f.launches, f.captured) for f in (dcn_fwd, dcn_bwd)]
    for b, w in zip(batches, want):
        _, losses = unit(graphed, b)
        for k, v in w.items():
            assert torch.equal(losses[k], v), k
    got = [(f.launches - a, f.captured - c) for f, (a, c) in zip((dcn_fwd, dcn_bwd), counts)]
    n_dcn = got[0][1]
    assert n_dcn > 0 and got == [((WARMUP_ITERS + 3) * n_dcn, n_dcn)] * 2
    assert len(unit.graphs.graphs) == 1
    got, ref = graphed.tensors(), eager.tensors()
    assert graphed.step == eager.step == 3 and set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(gen_g.get_state(), gen_e.get_state())


@pytest.mark.gpu
def test_graph_capture_leaves_the_state_untouched():
    """``prepare`` runs the step once on the live state and captures: every
    tensor, the generator and both step counts are as before."""
    from ppyolo_tpu_torch.train.graphs import GraphedStep

    _cuda_or_skip()
    _, _, state, step, gen = _train_setup()
    unit = GraphedStep(step, state, gen)
    before = {k: v.clone() for k, v in state.tensors().items()}
    gen_before = gen.get_state()
    unit.prepare(_gpu_batch(50, 2, 64))
    unit.prepare(_gpu_batch(51, 2, 96))
    assert len(unit.graphs.graphs) == 2 and state.step == 0
    after = state.tensors()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert torch.equal(gen.get_state(), gen_before)


@pytest.mark.gpu
def test_replays_outlive_destroyed_graphs_that_shared_their_generator():
    """Four units captured on one state and one registered generator (DropBlock
    draws from it): one step and two steps, each at 64 and at 96 px.  After
    each is replayed once, two are destroyed (``del``, ``gc.collect()``,
    ``empty_cache()``, then their freed memory written over), the other two
    replay on, then one more is destroyed and the last replays: every unit's
    losses, and the state and the generator at the end, bitwise equal to the
    same units run eagerly from the same state and generator state.  Every
    replay runs inside a torch.profiler session of its own (CUPTI set up and
    torn down around it unless ``Graphs`` keeps it set up: the teardown made
    such a replay crash, or lose kernel records, at full size), and each
    session's trace holds the K1 and K3 launches the counters count."""
    import gc

    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import make_multi_train_step
    from ppyolo_tpu_torch.utils.profiling import device_trace

    _cuda_or_skip()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg, _, eager, step_e, gen_e = _train_setup()
    _, _, graphed, step_g, gen_g = _train_setup()
    multi_e = make_multi_train_step(eager.model, cfg, n_steps=2, compute_dtype=torch.bfloat16)
    multi_g = make_multi_train_step(graphed.model, cfg, n_steps=2, compute_dtype=torch.bfloat16)
    units, inputs = {}, {}
    for size in (64, 96):
        one = _gpu_batch(60 + size, 2, size)
        two = [_gpu_batch(61 + size + i, 2, size) for i in range(2)]
        inputs[1, size] = one
        inputs[2, size] = {k: torch.stack([b[k] for b in two]) for k in two[0]}
        units[1, size] = GraphedStep(step_g, graphed, gen_g)
        units[2, size] = GraphedStep(multi_g, graphed, gen_g, n_steps=2)
    for key, unit in units.items():
        unit.prepare(inputs[key])

    def run(key):
        _, want = (step_e if key[0] == 1 else multi_e)(eager, inputs[key], gen_e)
        counts = (dcn_fwd.launches, dcn_bwd.launches)
        with device_trace() as prof:
            _, got = units[key](graphed, inputs[key])
            torch.cuda.synchronize()
        traced = [sum(e.count for e in prof.key_averages() if name in e.key)
                  for name in ("dcn_fwd_kernel", "dcn_bwd_kernel")]
        assert traced == [dcn_fwd.launches - counts[0], dcn_bwd.launches - counts[1]], key
        assert traced[0] > 0
        for k, v in want.items():
            assert torch.equal(got[k], v), (key, k)

    for key in list(units):
        run(key)
    for key in ((1, 64), (2, 96)):
        del units[key]
    gc.collect()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 26,), -1.0, device="cuda")     # over the freed blocks
    for _ in range(2):
        for key in list(units):
            run(key)
    del units[2, 64]
    gc.collect()
    torch.cuda.empty_cache()
    junk.fill_(float("nan"))
    for _ in range(2):
        run((1, 96))
    torch.cuda.synchronize()
    assert graphed.step == eager.step
    for k, v in eager.tensors().items():
        assert torch.equal(graphed.tensors()[k], v), k
    assert torch.equal(gen_g.get_state(), gen_e.get_state())


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["mini2x", "2x"])
def test_profiled_replay_after_destroyed_graphs_freed_their_memory(model):
    """ROADMAP §3 fault 1 (settled), reproduced by
    ``tools/graph_teardown.py`` in a subprocess, so a segfault fails this
    test instead of ending pytest: a profiler session, a one-step and a
    multi-step unit captured on one generator, the multi-step unit
    destroyed and ``empty_cache()``, then six profiled replays of the
    one-step unit.  Before ``GraphPool`` kept the pools' segments, the
    mini-2x program segfaulted in its second profiled replay and the
    ppyolo_2x@608 b8 one in some runs."""
    _cuda_or_skip()
    args = (["--model", "mini2x", "--size", "96", "--batch", "2", "--steps", "2"]
            if model == "mini2x" else [])
    r = subprocess.run([sys.executable, "-m", "ppyolo_tpu_torch.tools.graph_teardown",
                        *args, "--sessions", "6"], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, (r.returncode, r.stderr[-3000:])
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and len(out["k1_per_session"]) == 6 and min(out["k1_per_session"]) > 0


@pytest.mark.gpu
def test_head_modes_capture_graphs_of_their_own():
    """bf16 mini-2x serving at 96 px under each ``head_decompose`` mode: a
    graph of its own per mode (the Detector keys its graphs by the mode),
    each replay bitwise its mode's eager forward; ``inner`` and ``on``
    within 2e-2 (relative L2) of ``off`` on the raw maps."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.models.head import head_decompose

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    sd = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    det = Detector(PPYOLO.from_config(cfg), sd, cfg, target_size=96, precision="bf16")
    r = np.random.RandomState(3)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    x = det.normalize(torch.from_numpy(images).cuda())
    maps = {}
    for mode in ("off", "inner", "on"):
        with head_decompose(mode), torch.no_grad():
            got = det.predict_batch(images, sizes)
            want = det.model.predict(x, torch.from_numpy(sizes).cuda()).cpu().numpy()
            maps[mode] = [m.float() for m in det.model.outputs(x)]
        np.testing.assert_array_equal(got, want)
    assert sorted(key[1] for key in det._graphs) == ["inner", "off", "on"]
    for mode in ("inner", "on"):
        for a, b in zip(maps[mode], maps["off"]):
            assert float((a - b).norm() / b.norm()) <= 2e-2, mode


@pytest.mark.gpu
def test_kernel_form_artifact_launches_k1_and_k2():
    """A bf16 mini-2x artifact in the kernel form on the card: K1 once a
    DCN and K2 once a call, through the ``ppyolo::`` operators, detections
    equal to ``predict_batch``; the plain form launches neither."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.eval.export import export_detector, load_serving
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    n_dcn = sum(m.use_dcn for m in model.modules() if isinstance(m, ConvNormAct))
    det = Detector(model, model.state_dict(), cfg, target_size=96, precision="bf16")
    r = np.random.RandomState(4)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    want = det.predict_batch(images, sizes)
    for form, per_call in (("kernel", (n_dcn, 1)), ("plain", (0, 0))):
        serve = load_serving(export_detector(det, batch=2, dcn=form, stem=form))
        serve(images, sizes)
        before = (deform_conv_launches(), fused_stem.launches)
        got = serve(images, sizes)
        torch.cuda.synchronize()
        assert (deform_conv_launches() - before[0], fused_stem.launches - before[1]) == per_call
        if form == "kernel":
            np.testing.assert_array_equal(got[..., 0], want[..., 0])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def deform_conv_launches():
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd

    return dcn_fwd.launches


@pytest.mark.gpu
def test_int8_refreshes_free_the_graphs_they_replace():
    """Ten int8 refreshes of a mini-2x Detector at 96 px, ``set_params``
    (other weights each time) and ``calibrate`` in turn, a predict after
    each: each refresh releases its graph and the next predict captures
    anew in the same pool, reusing its blocks, so the memory reserved after
    the tenth is no more than after the second; every predict bitwise equal
    to the eager forward of those weights and scales."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    sds = [PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(s)).state_dict()
           for s in range(5)]
    det = Detector(PPYOLO.from_config(cfg), sds[0], cfg, target_size=96, precision="int8")
    r = np.random.RandomState(7)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    reserved, outs = [], []
    for cycle in range(10):
        if cycle % 2:
            det.calibrate(images)
        else:
            det.set_params(sds[cycle // 2])
        assert det._graphs == {}
        got = det.predict_batch(images, sizes)
        with torch.no_grad():
            want = det.model.predict(det.normalize(torch.from_numpy(images).cuda()),
                                     torch.from_numpy(sizes).cuda()).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        outs.append(got)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        assert [key[0] for key in det._graphs] == [1]     # (group, head mode, forms)
    assert reserved[9] <= reserved[1], reserved
    assert not hasattr(det, "_retired")
    assert not np.array_equal(outs[0], outs[2])


@pytest.mark.gpu
def test_graphed_predicts_are_bitwise_eager_and_follow_set_params():
    """bf16 serving of mini-2x at 96 px: the graphed ``predict_batch`` (K1
    and K2 inside) equals the eager forward; after ``set_params`` with other
    weights it equals the eager forward of those (the packed DCN weight,
    the folded stem and the BN affines are refreshed in place); and
    ``predict_pipelined`` of two batches equals two ``predict_batch``."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    sds = [PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(s)).state_dict()
           for s in (0, 1)]
    det = Detector(PPYOLO.from_config(cfg), sds[0], cfg, target_size=96, precision="bf16")
    r = np.random.RandomState(2)
    images = r.randint(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96], [300, 200], [96, 128]], np.float32)

    def eager(ims, szs):
        with torch.no_grad():
            x = det.normalize(torch.from_numpy(ims).cuda())
            return det.model.predict(x, torch.from_numpy(szs).cuda()).cpu().numpy()

    for sd in sds:
        det.set_params(sd)
        for lo in (0, 2):
            got = det.predict_batch(images[lo:lo + 2], sizes[lo:lo + 2])
            assert (got[..., 0] >= 0).any()
            np.testing.assert_array_equal(got, eager(images[lo:lo + 2], sizes[lo:lo + 2]))
        np.testing.assert_array_equal(
            det.predict_pipelined(images, sizes, group=2),
            np.concatenate([det.predict_batch(images[:2], sizes[:2]),
                            det.predict_batch(images[2:], sizes[2:])]))
    assert {key[0] for key in det._graphs} == {1, 2}    # (group, head mode, forms)


@pytest.mark.gpu
def test_graphed_predicts_follow_a_direct_load_into_the_model():
    """Weights written into the Detector's model by hand (not through
    ``set_params``) reach the graph too: before a replay the graphs see
    the parameters' versions move and refresh the caches they read."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.eval.optimize import optimize_for_inference
    from ppyolo_tpu_torch.models import PPYOLO

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    sds = [PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(s)).state_dict()
           for s in (0, 1)]
    det = Detector(PPYOLO.from_config(cfg), sds[0], cfg, target_size=96, precision="bf16")
    ref = Detector(PPYOLO.from_config(cfg), sds[1], cfg, target_size=96, precision="bf16")
    images = np.random.RandomState(3).randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    first = det.predict_batch(images, sizes)
    det.model.load_state_dict(optimize_for_inference(sds[1], precision="bf16"))
    got = det.predict_batch(images, sizes)
    np.testing.assert_array_equal(got, ref.predict_batch(images, sizes))
    assert not np.array_equal(got, first)


def _group(backend, tmp_path):
    """A one-rank process group of ``backend`` in this process."""
    import torch.distributed as tdist

    tdist.init_process_group(backend, init_method=f"file://{tmp_path / ('pg_' + backend)}",
                             rank=0, world_size=1)


@pytest.mark.gpu
def test_graphs_refuse_a_gloo_group_on_the_card(tmp_path):
    """gloo stages CUDA collectives through the host, which a CUDA graph
    cannot hold: under a gloo group ``Graphs`` on a card raises, and runs
    eagerly with ``capture=False``, the choice ``can_capture`` makes."""
    import torch.distributed as tdist

    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.graphs import Graphs

    dev = _cuda_or_skip()
    _group("gloo", tmp_path)
    try:
        assert not dist.can_capture(dev)
        with pytest.raises(RuntimeError, match="gloo"):
            Graphs(lambda inp: {"y": inp["x"] * 2}, dev)
        eager = Graphs(lambda inp: {"y": inp["x"] * 2}, dev, capture=False)
        x = torch.arange(4.0, device=dev)
        assert torch.equal(eager({"x": x})["y"], x * 2) and not eager.graphs
    finally:
        tdist.destroy_process_group()


@pytest.mark.gpu
def test_sync_bn_graphed_steps_under_nccl_equal_no_group(tmp_path):
    """Two bf16 ``sync_bn`` steps replayed from a CUDA graph captured under
    a one-rank NCCL group (the gradient bucket and every BN's statistics
    all-reduced inside the graph) equal two without a group bit for bit;
    a remat step's losses equal the plain step's and its BN statistics take
    one update."""
    import torch.distributed as tdist

    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    _cuda_or_skip()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg = _mini2x_cfg()
    cfg.backbone = dict(cfg.backbone, norm_type="sync_bn")
    cfg.head = dict(cfg.head, norm_type="sync_bn", drop_block=True)
    batches = [_gpu_batch(60 + i, 2, 96) for i in range(2)]

    def run(remat=False, n=2):
        model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
        model.to(device="cuda", memory_format=torch.channels_last)
        state = init_train_state(model, cfg)
        unit = GraphedStep(make_train_step(model, cfg, compute_dtype=torch.bfloat16,
                                           remat=remat),
                           state, torch.Generator(device="cuda").manual_seed(3))
        losses = [{k: v.clone() for k, v in unit(state, b)[1].items()} for b in batches[:n]]
        return losses, {k: v.clone() for k, v in state.tensors().items()}, unit

    want, want_state, keep = run()
    _group("nccl", tmp_path)
    try:
        assert dist.can_capture(torch.device("cuda")) and dist.backend() == "nccl"
        got, got_state, keep_g = run()
        remat, remat_state, keep_r = run(remat=True, n=1)
    finally:
        tdist.destroy_process_group()
    for w, g in zip(want, got):
        assert all(torch.equal(g[k], w[k]) for k in w)
    assert all(torch.equal(got_state[k], v) for k, v in want_state.items())
    _, one_state, keep_1 = run(n=1)
    np.testing.assert_allclose(float(remat[0]["total_loss"]), float(want[0]["total_loss"]),
                               rtol=1e-5)
    running = [k for k in one_state if "running_" in k]
    assert running and all(torch.equal(remat_state[k], one_state[k]) for k in running)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", [None, "nccl"])
def test_capture_survives_a_dead_graph_in_a_reference_cycle(backend, tmp_path):
    """A captured graph held only by a dead reference cycle (as a dropped
    Detector holds its graphs) is destroyed by the garbage collector.
    ``Graphs`` collects before capturing and holds the collector off while
    it captures, so a collection that lands inside the capture (under a
    one-rank NCCL group too, ``thread_local`` mode) finds nothing to
    destroy and the capture holds."""
    import gc

    import torch.distributed as tdist

    from ppyolo_tpu_torch.train.graphs import Graphs

    _cuda_or_skip()
    if backend:
        _group(backend, tmp_path)
    try:
        x = torch.zeros(4, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        gc.disable()   # the cycle stays uncollected until a collection runs
        try:
            dead = torch.cuda.CUDAGraph()
            with torch.cuda.graph(dead):
                x.add_(1)
            cycle = {"graph": dead}
            cycle["self"] = cycle
            del dead, cycle

            def fn(inp):
                if torch.cuda.is_current_stream_capturing():
                    gc.collect()   # a collection that lands inside the capture
                return {"y": inp["x"] * 2 + 1}

            out = Graphs(fn, "cuda")({"x": torch.ones(4)})
            torch.cuda.synchronize()
        finally:
            gc.enable()
        assert torch.equal(out["y"].cpu(), torch.full((4,), 3.0))
    finally:
        if backend:
            tdist.destroy_process_group()


# ---------------------------------------------------------------- K5, K6: int8 serving

def _int8_conv_inputs(seed, n, h, w, c, co, k, dev):
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(n, h, w, c) * 1.5).astype(np.float32))
    x = x.to(dev, torch.bfloat16).permute(0, 3, 1, 2)          # channels_last memory
    wq = torch.from_numpy(r.randint(-127, 128, (co, c, k, k)).astype(np.int8)).to(dev)
    ws = torch.from_numpy((r.rand(co) * 1e-3 + 1e-4).astype(np.float32)).to(dev)
    bias = torch.from_numpy((r.randn(co) * 0.1).astype(np.float32)).to(dev, torch.bfloat16)
    return x, wq, ws, bias


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 10, 32, 24, 1, 1), (2, 9, 10, 32, 24, 1, 2),
                                   (2, 11, 7, 130, 64, 1, 1), (1, 19, 19, 258, 128, 1, 1),
                                   (2, 10, 10, 514, 256, 1, 1), (1, 13, 13, 2050, 512, 1, 1),
                                   (2, 16, 16, 64, 64, 3, 1), (2, 38, 38, 128, 128, 3, 2),
                                   (1, 19, 19, 136, 200, 3, 1), (1, 7, 9, 45, 18, 3, 2),
                                   (8, 76, 76, 256, 256, 3, 2), (2, 45, 38, 96, 1024, 3, 1),
                                   (8, 19, 19, 514, 1024, 3, 1), (8, 19, 19, 512, 2048, 1, 1),
                                   (8, 19, 19, 2050, 512, 1, 1), (2, 76, 45, 130, 200, 3, 1),
                                   (1, 38, 19, 258, 512, 3, 2), (8, 38, 38, 1282, 256, 1, 1),
                                   (8, 19, 19, 4096, 512, 1, 1), (8, 19, 19, 2048, 512, 3, 1),
                                   (8, 38, 38, 1024, 256, 3, 2), (2, 11, 7, 2306, 130, 1, 2),
                                   (2, 11, 7, 130, 37, 1, 1), (1, 19, 19, 64, 255, 3, 1),
                                   (2, 9, 9, 45, 23, 3, 2), (1, 9, 8, 1600, 129, 3, 1)])
def test_int8_conv_kernel_is_bitwise_plain(shape, static, with_bias):
    """K5 bit-equal to ``quantized_conv2d_plain`` (the exact int8 sum, the
    JAX dequant order) at the edges of its tiles: H and W past the 16 x 8
    or 8 x 8 patch (19, 38, 45, 76), halos at every image border, C tails
    130/258/514/1282/2050 (C = 2 mod 8: 4-byte loads, an odd number of k32
    steps), 45 (odd: 2-byte loads), 136, ragged pixel and Co tails (Co 18,
    200), Co past one 128 or 256 column block (1024), the Co split the plan
    picks at M = 2888 (19x19, b8), both warpgroup layouts, stride 2 for 1x1
    and 3x3, with and without a bias, dynamic and static scales; C past a
    resident A tile (streamed in chunks: a 1x1 with C 4096, a 3x3 with C
    2048 at 19x19 b8, a 3x3 s2 with C 1024, C 2306 and 1600 with a short last
    chunk) and odd Co (37, 255, 23, 129)."""
    from ppyolo_tpu_torch.ops.conv_int8 import (dynamic_act_scale, quantized_conv2d,
                                                quantized_conv2d_plain)

    dev = _cuda_or_skip()
    n, h, w, c, co, k, stride = shape
    x, wq, ws, bias = _int8_conv_inputs(sum(shape), n, h, w, c, co, k, dev)
    act = (dynamic_act_scale(x) * 0.6) if static else None     # static: clips the largest
    kw = dict(stride=stride, padding=(k - 1) // 2, bias=bias if with_bias else None,
              act_scale=act)
    before = quantized_conv2d.launches
    with torch.no_grad():
        got = quantized_conv2d(x, wq, ws, **kw)
        want = quantized_conv2d_plain(x, wq, ws, **kw)
    torch.cuda.synchronize()
    assert quantized_conv2d.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    assert got.abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-6 / 127, 0.02, 1e-4, 7 * 2.0 ** -6, 1e-25])
def test_int8_conv_kernel_quantizes_every_bf16_as_quantize_act(scale):
    """Every finite bf16 bit pattern (65,280; NaN and Inf read as 0) through
    K5 as a 1x1 conv with an identity weight: y = bf16(q * s_x), and q ->
    y is one to one, so y equal to ``quantize_act``'s q dequantized means
    the same int8 for every pattern.  Scales: the smallest dynamic scale,
    a typical one, one that clips most of them, and 7 * 2^-6, whose inexact
    reciprocal alone rounds 6 exact halves the wrong way (all four on K5's
    reciprocal-and-FMA quotient), and one below 2^-64 (its true division)."""
    from ppyolo_tpu_torch.ops.conv_int8 import quantize_act, quantized_conv2d

    dev = _cuda_or_skip()
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).clone()
    x[~torch.isfinite(x.float())] = 0
    x = x.view(1, 64, 64, 16).to(dev).permute(0, 3, 1, 2)      # channels_last, C = 16
    wq = torch.eye(16, dtype=torch.int8, device=dev).view(16, 16, 1, 1)
    ws = torch.ones(16, device=dev)
    s_x = torch.tensor(scale, dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = quantized_conv2d(x, wq, ws, stride=1, padding=0, act_scale=s_x)
    q = quantize_act(x, s_x)
    want = (q.float() * s_x).to(torch.bfloat16)
    levels = (torch.arange(-127, 128, device=dev).float() * s_x).to(torch.bfloat16)
    assert levels.unique().numel() == 255                       # q -> y is one to one
    assert torch.equal(got, want), int((got != want).sum())
    assert q.min() == -127 and q.max() == 127                   # the clip is exercised


@pytest.mark.gpu
def test_int8_conv_kernel_refuses_what_it_does_not_take():
    from ppyolo_tpu_torch.ops.conv_int8 import pack_int8_weight, quantized_conv2d

    dev = _cuda_or_skip()
    x, wq, ws, bias = _int8_conv_inputs(0, 1, 8, 8, 32, 24, 3, dev)
    with pytest.raises(ValueError, match="bf16"):
        quantized_conv2d(x.float(), wq, ws, stride=1, padding=1)
    with pytest.raises(ValueError, match="weight_scale"):
        quantized_conv2d(x, wq, ws.cpu(), stride=1, padding=1)
    with pytest.raises(ValueError, match="packed"):
        quantized_conv2d(x, wq, ws, stride=1, padding=1,
                         packed=pack_int8_weight(wq)[:, :-16].contiguous())
    with pytest.raises(ValueError, match="not supported"):
        quantized_conv2d(x, wq, ws, stride=3, padding=1)


NMS_THR = 0.45


def k6_iou(a, b):
    """pairwise_iou(a, b, eps=1e-9) of row-paired fp32 boxes [..., 4] in numpy,
    every op rounded to fp32 on its own, in ``ops/iou.py``'s order (K6's IoU);
    also returns the rounded area sum and the unclamped-then-clamped w, h."""
    f32 = np.float32
    w = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    h = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    w, h = np.where(w < 0, f32(0), w), np.where(h < 0, f32(0), h)
    inter = w * h
    areas = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]) + \
        (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / ((areas - inter) + f32(1e-9)), (inter, areas, w, h)


def k6_iou_contracted(a, b):
    """``k6_iou`` as nvcc would compile it by default: the union's
    ``areas - w * h`` as one FMA (the product exact, one rounding; exact in
    fp64 for these magnitudes, then rounded once to fp32)."""
    _, (inter, areas, w, h) = k6_iou(a, b)
    union = (areas.astype(np.float64) - w.astype(np.float64) * h.astype(np.float64))
    return inter / (union.astype(np.float32) + np.float32(1e-9))


def k6_edge_pairs(seed, n, thr=NMS_THR):
    """Up to n pairs of fp32 boxes (a [m, 4], b [m, 4]) in a 608-px image
    whose IoU rounds to float32(thr) or to one of its two neighbours, the
    pairs where an FMA-contracted union flips the ``> thr`` decision first:
    b is a shifted by the offset that solves IoU = thr, stepped by ulps."""
    f32 = np.float32
    r = np.random.RandomState(seed)
    m, steps = 2000, np.arange(-64, 65)
    x0, y0 = (r.uniform(0, 400, (2, m))).astype(f32)
    wd, ht = (r.uniform(20, 200, (2, m))).astype(f32)
    a = np.stack([x0, y0, x0 + wd, y0 + ht], -1).astype(f32)
    bx = (x0 + (wd * (1 - thr) / (1 + thr)).astype(f32))[:, None]
    bx = (bx + steps[None, :] * np.spacing(bx)).astype(f32)
    ones = np.ones_like(bx)
    b = np.stack([bx, y0[:, None] * ones, (bx + wd[:, None]).astype(f32),
                  (y0 + ht)[:, None] * ones], -1).astype(f32)
    a = np.broadcast_to(a[:, None, :], b.shape).reshape(-1, 4)
    b = b.reshape(-1, 4)
    t = f32(thr)
    rn, fm = k6_iou(a, b)[0], k6_iou_contracted(a, b)
    edge = (rn == t) | (rn == np.nextafter(t, f32(0))) | (rn == np.nextafter(t, f32(1)))
    flips = (rn > t) != (fm > t)
    order = np.argsort(~(edge & flips), kind="stable")
    pick = order[:n][edge[order[:n]]]
    return a[pick], b[pick]


def k6_clustered(seed, b, k):
    """valid [b, k], boxes [b, k, 4] fp32 and labels [b, k] int32 of k
    candidates in score order, as ``multiclass_nms`` gives them to K6: boxes
    in 24 clusters (suppressions chain), 4 labels, 10% invalid."""
    r = np.random.RandomState(seed)
    centres = r.rand(b, 24, 2) * 608
    xy = np.take_along_axis(centres, r.randint(0, 24, (b, k, 1)), 1) + r.randn(b, k, 2) * 6
    wh = 20 + r.rand(b, k, 2) * 60
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    return r.rand(b, k) < 0.9, boxes, r.randint(0, 4, (b, k)).astype(np.int32)


def k6_edge_case(seed, b, k):
    """valid, boxes, labels of b images of k candidates made of threshold-edge
    pairs (``k6_edge_pairs``), each pair its own label: candidate 2m + 1 is
    kept exactly when its pair's IoU is not above the threshold."""
    pa, pb = k6_edge_pairs(seed, b * ((k + 1) // 2))
    n = (k + 1) // 2
    boxes = np.stack([pa, pb], 1).reshape(-1, 4)
    reps = -(-b * 2 * n // len(boxes))
    boxes = np.tile(boxes, (reps, 1))[:b * 2 * n].reshape(b, 2 * n, 4)[:, :k]
    labels = np.broadcast_to(np.arange(2 * n)[None, :] // 2, (b, 2 * n))[:, :k]
    return np.ones((b, k), bool), np.ascontiguousarray(boxes), labels.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clustered", "edge"])
@pytest.mark.parametrize("b,k", [(8, 500), (3, 97), (2, 1024), (1, 1), (2, 32), (2, 33),
                                 (2, 1025), (1, 4096), (1, 8000)])
def test_nms_keep_kernel_is_bitwise_plain(b, k, case):
    """K6, from the candidates' boxes, equal to its plain version (the eager
    suppress matrix and the fixpoint) at k within one chunk, on a chunk
    edge (32, 33), past the first form's cap of 1024, and past shared
    memory (8000: the global scratch path), on clustered boxes and on pairs
    at the threshold's rounding edge, where an FMA-contracted IoU decides
    otherwise."""
    from ppyolo_tpu_torch.ops.matrix_nms import nms_keep, nms_keep_boxes_plain

    dev = _cuda_or_skip()
    valid, boxes, labels = (k6_clustered if case == "clustered" else k6_edge_case)(
        b * 1000 + k, b, k)
    args = [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in (valid, boxes, labels)]
    before = nms_keep.launches
    got = nms_keep(*args, NMS_THR)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    want = nms_keep_boxes_plain(*args, NMS_THR)
    assert torch.equal(got, want), int((got != want).sum())
    if case == "edge" and k > 1:
        assert 0 < int(got.sum()) < b * k     # some pairs suppress, some do not
    with pytest.raises(ValueError, match="fp32 boxes"):
        nms_keep(args[0], args[1].double(), args[2], NMS_THR)


@pytest.mark.gpu
@pytest.mark.parametrize("nms_type", ["matrix_nms", "multiclass_nms"])
def test_int8_detector_graphed_is_bitwise_eager(nms_type):
    """int8 serving of mini-2x at 96 px: the graphed ``predict_batch``
    equals the eager forward with dynamic scales, after ``calibrate`` (the
    graph set aside and captured anew, the scales fp32) and after
    ``set_params`` (dynamic again); every int8 conv runs K5 on the card,
    never the plain version: K5 launches once per int8 conv per forward, K6
    once per multiclass forward."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops import conv_int8
    from ppyolo_tpu_torch.ops.conv import ConvNormAct
    from ppyolo_tpu_torch.ops.matrix_nms import nms_keep

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    cfg.nms_cfg = dict(cfg.nms_cfg, nms_type=nms_type)
    sds = [PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(s)).state_dict()
           for s in (0, 1)]
    det = Detector(PPYOLO.from_config(cfg), sds[0], cfg, target_size=96, precision="int8")
    n8 = sum(isinstance(m, ConvNormAct) and m.conv.is_int8 for m in det.model.modules())
    assert n8 > 30
    r = np.random.RandomState(4)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    plain_calls = []
    real_plain = conv_int8.quantized_conv2d_plain
    conv_int8.quantized_conv2d_plain = lambda *a, **kw: plain_calls.append(1) or real_plain(*a, **kw)

    def eager():
        with torch.no_grad():
            x = det.normalize(torch.from_numpy(images).cuda())
            return det.model.predict(x, torch.from_numpy(sizes).cuda()).cpu().numpy()

    try:
        outs = []
        for step in ("dynamic", "calibrated", "set_params"):
            if step == "calibrated":
                assert det.calibrate(images) == n8
                for m in det.model.modules():
                    if isinstance(m, ConvNormAct) and m.conv.is_int8:
                        assert m.conv.act_scale.dtype == torch.float32
            elif step == "set_params":
                det.set_params(sds[1])
                assert not any(k.endswith("act_scale") for k in det.model.state_dict())
            k5, k6 = conv_int8.quantized_conv2d.launches, nms_keep.launches
            got = det.predict_batch(images, sizes)
            want = eager()
            torch.cuda.synchronize()
            # the capture's eager warm-up run, the replay and the eager forward
            assert conv_int8.quantized_conv2d.launches - k5 == 3 * n8
            assert nms_keep.launches - k6 == (3 if nms_type == "multiclass_nms" else 0)
            assert (got[..., 0] >= 0).any()
            np.testing.assert_array_equal(got, want)
            outs.append(got)
        assert not hasattr(det, "_retired") and [key[0] for key in det._graphs] == [1]
        assert not np.array_equal(outs[0], outs[2])
        assert plain_calls == []
    finally:
        conv_int8.quantized_conv2d_plain = real_plain


@pytest.mark.gpu
@pytest.mark.parametrize("norm,act", [("gn", "relu"), ("gn", "mish"), ("affine_channel", "leaky")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_conv_norm_act_on_the_card_matches_the_cpu(norm, act, dtype):
    """A GN (or affine_channel) ConvNormAct, 3x3 C 64, on the card against
    the same layer on the CPU: within 2e-2 relative L2 in bf16 (cuDNN's
    bf16 conv against the CPU's) and 1e-5 in fp32 (TF32 off); the DCN form
    of the layer too, through K1."""
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    dev = _cuda_or_skip()
    for dcn in (False, True):
        m = ConvNormAct(64, 64, 3, norm=norm, act=act, use_dcn=dcn)
        m.init_parameters(torch.Generator().manual_seed(0))
        r = np.random.RandomState(1)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if "conv_offset" in name:
                    p.copy_(torch.from_numpy((r.randn(*p.shape) * 0.02).astype(np.float32)))
                elif name.startswith(("gn.", "af.")):
                    p.add_(torch.from_numpy((r.randn(*p.shape) * 0.3).astype(np.float32)))
        x = _nchw(r.randn(2, 19, 19, 64).astype(np.float32), dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            want = m.to(dtype)(x).double()
            got = m.to(dev)(x.to(dev)).double().cpu()
        torch.cuda.synchronize()
        # K1 rounds an fp32 layer's operands to bf16, as in bf16
        tol = 1e-5 if dtype == torch.float32 and not dcn else 2e-2
        assert float((got - want).norm() / want.norm()) <= tol, (norm, act, dcn)


@pytest.mark.gpu
def test_int8_artifact_is_bitwise_predict_batch():
    """The int8 mini-2x artifact at b2 in the kernel form on the card:
    dynamic and calibrated scales, each bitwise ``predict_batch``, K5 once
    an int8 conv a call (``ppyolo::quantized_conv2d``), K1 once a DCN, K2
    once."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.eval.export import export_detector, load_serving
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops import conv_int8
    from ppyolo_tpu_torch.ops.conv import ConvNormAct
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd

    _cuda_or_skip()
    cfg = _mini2x_cfg()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), cfg, target_size=96, precision="int8")
    n8 = sum(isinstance(m, ConvNormAct) and m.conv.is_int8 for m in det.model.modules())
    n_dcn = sum(isinstance(m, ConvNormAct) and m.use_dcn for m in det.model.modules())
    r = np.random.RandomState(4)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    for calibrated in (False, True):
        if calibrated:
            det.calibrate(images)
        want = det.predict_batch(images, sizes)
        serve = load_serving(export_detector(det, batch=2, dcn="kernel", stem="kernel"))
        serve(images, sizes)
        before = (conv_int8.quantized_conv2d.launches, dcn_fwd.launches, fused_stem.launches)
        got = serve(images, sizes)
        torch.cuda.synchronize()
        after = (conv_int8.quantized_conv2d.launches, dcn_fwd.launches, fused_stem.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (n8, n_dcn, 1)
        assert (want[..., 0] >= 0).any()
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_kernel_flops_reports_the_launches_of_a_card_unit():
    """``utils/mfu.kernel_flops`` of a mini-2x bf16 predict and of a train
    step on the card: every kernel place marked launched, K1 and K2 in the
    predict, K1 and K3 in the step; and the unit's FLOPs counted by
    ``Graphs`` on the card equal the CPU's count of the same unit."""
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.conv import ConvNormAct
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step
    from ppyolo_tpu_torch.utils.mfu import kernel_flops

    dev = _cuda_or_skip()
    cfg = _mini2x_cfg()
    cfg.head = dict(cfg.head, drop_block=False)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    n_dcn = sum(isinstance(m, ConvNormAct) and m.use_dcn for m in model.modules())
    x = torch.randn(2, 3, 96, 96).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    serving = PPYOLO.from_config(cfg).to(dev, torch.bfloat16).eval()
    with torch.no_grad():
        calls = kernel_flops(serving.outputs, x)
    assert sorted(n for n, _, _ in calls) == sorted(["dcn_fwd"] * n_dcn + ["fused_stem"])
    assert all(launched and f > 0 for _, f, launched in calls)

    r = np.random.RandomState(0)
    gt = np.zeros((2, 50, 4), np.float32)
    gt[:, :3, :2], gt[:, :3, 2:] = r.uniform(0.2, 0.8, (2, 3, 2)), r.uniform(0.1, 0.4, (2, 3, 2))
    score = np.zeros((2, 50), np.float32)
    score[:, :3] = 1.0
    batch = {"image": r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8), "gt_bbox": gt,
             "gt_class": r.randint(0, 2, (2, 50)).astype(np.int32), "gt_score": score}
    flops = {}
    for d in ("cpu", dev):
        m = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0)).to(d)
        state = init_train_state(m, cfg)
        step = GraphedStep(make_train_step(m, cfg), state, None)
        unit = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        if d == dev:
            calls = kernel_flops(make_train_step(m, cfg), state, unit)
            assert sorted(n for n, _, _ in calls) == sorted(["dcn_fwd", "dcn_bwd"] * n_dcn)
            assert all(launched for _, _, launched in calls)
        step.prepare(unit)
        flops[str(d)] = step.unit_flops(unit)
    assert flops["cpu"] > 0 and flops["cuda"] == pytest.approx(flops["cpu"], rel=1e-6)


@pytest.mark.gpu
def test_graph_launch_spans_hold_their_cuda_graph_launch():
    """Five graphed bf16 mini-2x predicts at 96 px in a device trace with a
    recording open: each ``graph.launch`` span holds the one
    ``cudaGraphLaunch`` runtime record of its replay (the spans and the
    profiler's records stand on one clock), inside its ``serve.call``; the
    block's ``device_allocs`` is counted."""
    from torch.autograd import DeviceType

    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.utils.profiling import device_trace, recording

    dev = _cuda_or_skip()
    cfg = _mini2x_cfg()
    sd = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    det = Detector(PPYOLO.from_config(cfg), sd, cfg, target_size=96, precision="bf16")
    r = np.random.RandomState(5)
    images = r.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [96, 96]], np.float32)
    det.predict_batch(images, sizes)        # the capture
    with device_trace() as prof, recording(dev) as rec:
        for _ in range(5):
            det.predict_batch(images, sizes)
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CPU and "cudaGraphLaunch" in e.name()]
    by_id = {s.id: s for s in rec.spans}
    spans = [s for s in rec.spans if s.name == "graph.launch"]
    assert len(spans) == len(launches) == 5
    for s in spans:
        assert sum(s.start_ns <= a and b <= s.end_ns for a, b in launches) == 1, s
        assert by_id[s.root].name == "serve.call"
    assert rec.counters["device_allocs"] >= 0


# K7, train-mode BatchNorm with its activation: ppyolo_2x's stem (C 32 at
# 304²), stage 2 (C 256 at 152²), stage 5 (C 2048 at 19²) and a head layer
# (C 512 at 38²), at b8
BN_SHAPES = [(8, 32, 304, 304), (8, 256, 152, 152), (8, 2048, 19, 19), (8, 512, 38, 38)]
# max-abs error over the plain path's max-abs.  y and dx: rounded to x's
# dtype after fp32 statistics summed in another order; bf16 keeps 8 bits, and
# in fp32 a channel whose offset is large against its spread loses digits to
# E[x²] - m² in both paths (1.8e-5 of y read at C 512, 38²).  dweight and
# dbias: fp32 sums of 10^4-10^6 terms in another order, rounded to the
# parameters' dtype.  Running statistics: fp32.  Where y lies a rounding
# from 0 the two paths may disagree on the activation's mask (a handful of
# elements in 10^7): ``_bn_compare`` leaves those elements out of dx and
# allows dweight and dbias their gradient.
BN_TOL = {torch.bfloat16: dict(y=1e-2, dx=2e-2, dparam=1e-2, running=1e-5),
          torch.float32: dict(y=1e-4, dx=1e-4, dparam=1e-4, running=1e-5)}
BN_OUTS = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")


def _bn_case(shape, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    cl = torch.channels_last
    # per-channel offsets and scales, as a conv's output has them
    x = (torch.randn(shape, generator=g) * (torch.rand(c, 1, 1, generator=g) * 2 + 0.2)
         + torch.randn(c, 1, 1, generator=g))
    params = [torch.randn(c, generator=g) * 0.3 + 1.0, torch.randn(c, generator=g) * 0.5]
    running = [torch.randn(c, generator=g) * 0.1, torch.rand(c, generator=g) + 0.5]
    dy = torch.randn(shape, generator=g)
    return (x.to(dev, dtype).contiguous(memory_format=cl), [p.to(dev, dtype) for p in params],
            [r.to(dev) for r in running], dy.to(dev, dtype).contiguous(memory_format=cl))


def _bn_close(name, got, want, rel, slack=0.0):
    err = (got.float() - want.float()).abs()
    ref = float(want.float().abs().max())
    assert bool((err <= rel * max(ref, 1e-30) + slack).all()), (
        f"{name}: max-abs error {float(err.max())} over {ref}")


def _bn_plain(x, params, running, dy, act):
    """autograd of ``_forward_train`` then ``apply_act``, on the card; with
    the pre-activation y as ``pre``."""
    from ppyolo_tpu_torch.ops.conv import apply_act
    from ppyolo_tpu_torch.ops.module import BatchNorm

    bn = BatchNorm(x.shape[1]).to(x.device).train()
    with torch.no_grad():
        for t, v in zip((bn.running_mean, bn.running_var), running):
            t.copy_(v)
    bn.weight, bn.bias = (torch.nn.Parameter(p.clone()) for p in params)
    xg = x.clone().requires_grad_(True)
    pre = bn._forward_train(xg)
    y = apply_act(pre, act)
    grads = torch.autograd.grad(y, (xg, bn.weight, bn.bias), dy)
    return dict(zip(BN_OUTS, (y.detach(),) + grads + (bn.running_mean, bn.running_var)),
                pre=pre.detach())


def _bn_fused(x, params, running, dy, act, **kw):
    from ppyolo_tpu_torch.ops.bn_train import bn_train
    from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM

    rm, rv = (r.clone() for r in running)
    w, b = (p.clone().requires_grad_(True) for p in params)
    xg = x.clone().requires_grad_(True)
    y = bn_train(xg, w, b, rm, rv, act=act, update=kw.get("update", True), sync=False,
                 eps=BN_EPS, momentum=BN_MOMENTUM)
    dx, dw, db = torch.autograd.grad(y, (xg, w, b), dy)
    return dict(zip(BN_OUTS, (y.detach(), dx, dw, db, rm, rv)))


def _bn_compare(got, want, pre, x, dy, act, dtype):
    """``got`` against ``want`` within BN_TOL, where ``pre`` is the plain
    path's pre-activation y.  An element whose mask the two disagree on must
    lie within the y tolerance of 0, and at most 1e-5 of them (or one); dx leaves
    them out, and dweight and dbias may differ by their terms."""
    from ppyolo_tpu_torch.ops.module import BN_EPS

    tol = BN_TOL[dtype]
    flip = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if act is not None:
        flip = (got["y"] > 0) != (pre > 0)
        near = pre.float().abs() <= tol["y"] * float(pre.float().abs().max())
        assert bool((near | ~flip).all()), "the activation's mask differs away from y ~ 0"
        assert int(flip.sum()) <= max(1.0, 1e-5 * flip.numel()), int(flip.sum())
    xf = x.float()
    m = xf.mean((0, 2, 3), keepdim=True)
    invstd = torch.rsqrt(xf.var((0, 2, 3), unbiased=False, keepdim=True) + BN_EPS)
    lost = dy.float().abs() * flip
    slack = {"dbias": lost.sum((0, 2, 3)),
             "dweight": (lost * (xf - m).abs() * invstd).sum((0, 2, 3))}
    for name in BN_OUTS:
        g, w = got[name], want[name]
        if name == "dx":
            g, w = g[~flip], w[~flip]
        rel = tol[{"dweight": "dparam", "dbias": "dparam", "running_mean": "running",
                   "running_var": "running"}.get(name, name)]
        _bn_close(name, g, w, rel, slack.get(name, 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "relu", "leaky"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES + [(3, 12, 9, 7), (2, 20, 5, 11)])
def test_bn_train_kernels_match_autograd_of_plain(shape, dtype, act):
    """K7 forward and backward against autograd of ``_forward_train`` then
    the activation on the same inputs: y, dx, dweight, dbias and both
    running statistics within ``BN_TOL`` (``_bn_compare``); one forward and
    one backward counted; outputs channels_last in x's and the parameters'
    dtypes.  C 12 (and C 20 in bf16) is no multiple of a 16-byte vector:
    the kernels load an element a thread there."""
    from ppyolo_tpu_torch.ops.bn_train import bn_train_bwd, bn_train_fwd

    dev = _cuda_or_skip()
    case = _bn_case(shape, dtype, 17, dev)
    counts = (bn_train_fwd.launches, bn_train_bwd.launches)
    got = _bn_fused(*case, act)
    torch.cuda.synchronize()
    assert (bn_train_fwd.launches - counts[0], bn_train_bwd.launches - counts[1]) == (1, 1)
    want = _bn_plain(*case, act)
    assert got["y"].dtype == got["dx"].dtype == got["dweight"].dtype == dtype
    assert got["y"].is_contiguous(memory_format=torch.channels_last)
    assert got["dx"].is_contiguous(memory_format=torch.channels_last)
    _bn_compare(got, want, want["pre"], case[0], case[3], act, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "leaky"])
def test_bn_train_graphed_replay_is_bitwise_eager(act):
    """One forward and backward of K7 captured in a CUDA graph and replayed
    equals the eager call bit for bit (fixed-order sums, no atomics),
    running statistics included; the capture records one call of each
    wrapper and launches none."""
    from ppyolo_tpu_torch.ops.bn_train import bn_train, bn_train_bwd, bn_train_fwd
    from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM

    dev = _cuda_or_skip()
    x, (w, b), (rm, rv), dy = _bn_case((8, 256, 76, 76), torch.bfloat16, 23, dev)
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    rm0, rv0 = rm.clone(), rv.clone()

    def step():
        y = bn_train(x, w, b, rm, rv, act=act, update=True, sync=False, eps=BN_EPS,
                     momentum=BN_MOMENTUM)
        return (y,) + torch.autograd.grad(y, (x, w, b), dy)

    want = [t.detach().clone() for t in step()]   # no autograd graph kept alive
    want_running = (rm.clone(), rv.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    counts = [(f.launches, f.captured) for f in (bn_train_fwd, bn_train_bwd)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    assert [(f.launches, f.captured) for f in (bn_train_fwd, bn_train_bwd)] == [
        (a, c + 1) for a, c in counts]
    rm.copy_(rm0)
    rv.copy_(rv0)
    graph.replay()
    torch.cuda.synchronize()
    for g, wt in zip(out, want):
        assert torch.equal(g, wt)
    assert torch.equal(rm, want_running[0]) and torch.equal(rv, want_running[1])


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_bn_train_split_batch_with_added_sums_is_the_whole_batch(act):
    """Sync-BN's arithmetic on one card: each half of a batch with the
    other half's [2C] sums added to its own (by hand, where the all-reduce
    would add them) over n × 2 values gives the whole batch's y, running
    statistics and dx, and the halves' dweight and dbias add up to the
    whole batch's, within ``BN_TOL`` (the halves sum in another order)."""
    from ppyolo_tpu_torch.ops.bn_train import bn_train_bwd, bn_train_fwd
    from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM

    dev = _cuda_or_skip()
    x, (w, b), running, dy = _bn_case((8, 512, 38, 38), torch.bfloat16, 29, dev)
    kw = dict(act=act, eps=BN_EPS)
    whole = _bn_fused(x, (w, b), running, dy, act)
    pre = _bn_plain(x, (w, b), running, dy, act)["pre"]
    halves, dys = x.chunk(2), dy.chunk(2)
    own = {}

    def keep(i):
        return lambda s: own.__setitem__(i, s.clone())

    def add_other(i):
        return lambda s: s.add_(own[1 - i])

    rm, rv = (r.clone() for r in running)
    for i, h in enumerate(halves):
        bn_train_fwd(h, w, b, rm, rv, update=False, momentum=BN_MOMENTUM, all_reduce=keep(i),
                     world=2, **kw)
    fwd = [bn_train_fwd(h, w, b, rm, rv, update=i == 0, momentum=BN_MOMENTUM,
                        all_reduce=add_other(i), world=2, **kw) for i, h in enumerate(halves)]
    for i, (g, h) in enumerate(zip(dys, halves)):
        bn_train_bwd(g, h, fwd[i][1], w, b, all_reduce=keep(i), world=2, **kw)
    bwd = [bn_train_bwd(g, h, fwd[i][1], w, b, all_reduce=add_other(i), world=2, **kw)
           for i, (g, h) in enumerate(zip(dys, halves))]
    torch.cuda.synchronize()
    assert torch.equal(fwd[0][1], fwd[1][1])
    got = dict(y=torch.cat([f[0] for f in fwd]), dx=torch.cat([o[0] for o in bwd]),
               dweight=bwd[0][1].float() + bwd[1][1].float(),
               dbias=bwd[0][2].float() + bwd[1][2].float(), running_mean=rm, running_var=rv)
    _bn_compare(got, whole, pre, x, dy, act, torch.bfloat16)


@pytest.mark.gpu
def test_bn_train_recompute_leaves_running_statistics_and_zero_variance_clamps():
    """Under ``_recomputing()`` a BatchNorm in training on the card leaves
    its running statistics as they were and gives the same y.  A channel of
    1.0 everywhere has E[x²] - m² = 0 exactly: v = 0, so y is the bias (its
    activation), the running variance moves to 0.9 of itself and the mean
    to 0.9 m + 0.1, bit for bit as the plain expression; dx there is
    k * (g - mean g) with the clamp's factor on a zero (x - m)."""
    from ppyolo_tpu_torch.ops.bn_train import bn_train
    from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM, BatchNorm, _recomputing

    dev = _cuda_or_skip()
    x, (w, b), (rm, rv), dy = _bn_case((8, 64, 38, 38), torch.bfloat16, 31, dev)
    x[:, 5] = 1.0
    bn = BatchNorm(64).to(dev).train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (w, b, rm, rv)):
            t.copy_(v)
    before = (bn.running_mean.clone(), bn.running_var.clone())
    with torch.no_grad(), _recomputing():
        y_re = bn(x, "relu")
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])
    with torch.no_grad():
        y = bn(x, "relu")
    assert torch.equal(y, y_re)
    assert torch.equal(y[:, 5], torch.relu(b[5].float()).to(y.dtype).expand_as(y[:, 5]))
    assert torch.equal(bn.running_var[5], (1 - BN_MOMENTUM) * before[1][5])
    assert torch.equal(bn.running_mean[5], (1 - BN_MOMENTUM) * before[0][5] + BN_MOMENTUM * 1.0)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = bn_train(xg, wg, bg, rm.clone(), rv.clone(), act=None, update=True, sync=False,
                 eps=BN_EPS, momentum=BN_MOMENTUM)
    dx = torch.autograd.grad(y, xg, dy)[0]
    g = dy[:, 5].float()
    k = float(w[5].float()) * (BN_EPS ** -0.5)
    want = (k * (g - g.mean())).to(dx.dtype)
    _bn_close("dx of the zero-variance channel", dx[:, 5], want, 1e-2)
