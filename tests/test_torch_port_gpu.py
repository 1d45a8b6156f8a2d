"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  Imports torch and numpy only (no JAX), so it runs on the
GPU machine: ``python -m pytest tests/test_torch_port_gpu.py -m gpu``.
Tolerance: max-abs error <= 2% of the plain output's max-abs (bf16 operands).
"""
import os

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
    assert set(det._graphs) == {1, 2}


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
