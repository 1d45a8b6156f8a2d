"""The port's ppyolo_2x slice against the JAX package, on the CPU.

JAX params from ``PRNGKey(123)`` go through the bridge into the port; the
port's fp32 ``predict``/``outputs`` must match ``tests/fixtures/golden_2x.npz``
at the tolerances of ``tests/test_golden.py`` and a live JAX forward with
perturbed offset convs (so DCN interpolates).  ppyolo_r18vd and
ppyolo_2x_custom (their own class counts) are held in fp64 against the JAX
package under x64.  The bf16 BN-folded serving forward is compared by
relative L2 per level: random-weight detections are too noisy to compare
in bf16 (``tests/test_optimize.py``).
"""
import ast
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from configs import PPYOLO_2x_Config, PPYOLO_2x_Custom_Config, PPYOLO_r18vd_Config
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.module import Ctx, flatten_tree as jax_flatten_tree
from ppyolo_tpu.eval.optimize import optimize_for_inference as jax_optimize

from ppyolo_tpu_torch.checkpoint.bridge import jax_params_to_state_dict
from ppyolo_tpu_torch.eval.optimize import optimize_for_inference
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops.module import flatten_tree, resolve_device, unflatten_tree

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "golden_2x.npz"


def _cfg():
    cfg = PPYOLO_2x_Config()
    cfg.num_classes = 6
    cfg.head = dict(cfg.head, num_classes=6)
    return cfg


def _inputs():
    rng = np.random.RandomState(42)
    images = rng.rand(2, 160, 160, 3).astype(np.float32)
    im_size = np.array([[480, 640], [160, 160]], np.float32)
    return images, im_size


@pytest.fixture(scope="module")
def jax_model_params():
    model = JaxPPYOLO.from_config(_cfg())
    params = model.init(jax.random.PRNGKey(123))
    return model, params


def _perturb_offsets(params):
    """Small random offset-conv weights so every DCN samples off-grid."""
    flat = jax_flatten_tree(params)
    r = np.random.RandomState(7)
    for k in sorted(flat):
        if k.endswith("conv_offset.weight") or k.endswith("conv_offset.bias"):
            flat[k] = jnp.asarray(r.randn(*flat[k].shape).astype(np.float32) * 0.02)
    return unflatten_tree(flat)


def _params(params, name):
    return _perturb_offsets(params) if name == "deformed" else params


_JIT = {}


def _jax_forward(jmodel, params, images, im_size):
    """Live JAX (predict, outputs) in one jitted program (eager dispatch of
    the 2x graph is ~20 s on the CPU), in the inputs' dtypes."""
    if jmodel not in _JIT:
        def both(p, x, s):
            ctx = Ctx(train=False)
            feats = jmodel.features(p, x, ctx)
            return (jmodel.head.get_prediction(p["head"], feats, s, ctx),
                    jmodel.head.get_outputs(p["head"], feats, ctx))

        _JIT[jmodel] = jax.jit(both)
    pred, outs = _JIT[jmodel](params, jnp.asarray(images), jnp.asarray(im_size))
    return np.asarray(pred), [np.asarray(o) for o in outs]


def _jax_forward_x64(jmodel, params, images, im_size):
    """The same forward in fp64 (params, images and arithmetic): the exact
    result that fp32 forwards round differently."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        return _jax_forward(jmodel, p64, images.astype(np.float64),
                            im_size.astype(np.float64))


@pytest.fixture(scope="module")
def jax_runs(jax_model_params):
    """Live JAX (predict, maps), memoised by (params name, "fp32"|"fp64")."""
    jmodel, params = jax_model_params
    memo = {}

    def run(name, precision):
        if (name, precision) not in memo:
            fwd = _jax_forward_x64 if precision == "fp64" else _jax_forward
            memo[name, precision] = fwd(jmodel, _params(params, name), *_inputs())
        return memo[name, precision]

    return run


def _port(flat_params, cfg=None):
    model = PPYOLO.from_config(cfg or _cfg())
    sd = jax_params_to_state_dict(
        {k: np.asarray(v) for k, v in flat_params.items()}, model)
    model.load_state_dict(sd)
    return model


def _maps(model, images, dtype=torch.float32):
    """The head's raw maps, NHWC numpy."""
    return [o.permute(0, 2, 3, 1).numpy() for o in model.to(dtype).outputs(_nchw(images, dtype))]


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float64) - y).max()) for x, y in zip(a, b))


def assert_pred_close(got, want):
    """Detections at test_golden's tolerances: labels exact, scores tight,
    boxes loose (exp decode)."""
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-3, atol=0.5)


def _nchw(images, dtype=torch.float32):
    return torch.from_numpy(images).to(dtype).permute(0, 3, 1, 2)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port (entries included) and not chip_smoke.py
    imports JAX, the JAX package or the repository's root ``tools``."""
    files = sorted((REPO / "ppyolo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert REPO / "ppyolo_tpu_torch" / "entry" / "train.py" in files
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "ppyolo_tpu", "flax", "optax", "tools")]
    assert bad == []


def test_state_dict_keys_are_the_jax_paths(jax_model_params):
    model, params = jax_model_params
    flat = jax_flatten_tree(params)
    port = PPYOLO.from_config(_cfg())
    sd = port.state_dict()
    assert set(sd) == set(flat)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    conv = jax_params_to_state_dict({k: np.asarray(v) for k, v in flat.items()}, port)
    for k, v in flat.items():
        t = conv[k].numpy()
        assert t.shape == sd[k].shape
        back = t.transpose(2, 3, 1, 0) if t.ndim == 4 else t   # OIHW -> HWIO
        np.testing.assert_array_equal(back, np.asarray(v))
    assert flatten_tree(unflatten_tree(conv)).keys() == conv.keys()


def test_bridge_rejects_missing_and_extra_keys(jax_model_params):
    _, params = jax_model_params
    flat = {k: np.asarray(v) for k, v in jax_flatten_tree(params).items()}
    port = PPYOLO.from_config(_cfg())
    missing = dict(flat)
    missing.pop("head.yolo_output_convs.2.conv.bias")
    with pytest.raises(KeyError, match="missing"):
        jax_params_to_state_dict(missing, port)
    with pytest.raises(KeyError, match="extra"):
        jax_params_to_state_dict(dict(flat, **{"head.extra.weight": np.zeros(1)}), port)
    bad = dict(flat)
    bad["backbone.stage5_0.conv2.conv.dcn_weight"] = np.zeros((3, 3, 512, 511), np.float32)
    with pytest.raises(ValueError, match="shape"):
        jax_params_to_state_dict(bad, port)


def test_fp32_predict_matches_golden_fixture(jax_model_params):
    """The fixture is one fp32 forward of the JAX package.  Measured here
    against the fp64 forward of the same model (the port's, which
    ``test_fp64_matches_live_jax_x64`` holds to the JAX package's at 1e-4)
    it is off by ~4.9e-3 at a max |out0| of 2127.5: more than
    test_golden's atol of 1e-4, which so holds only for the very fp32
    program that wrote it.  out0 is therefore held to the fixture through
    the exact forward: the fixture lies within fp32 rounding of it, and the
    port's fp32 out0 no farther from it than twice the fixture's distance."""
    _, params = jax_model_params
    model = _port(jax_flatten_tree(params))
    images, im_size = _inputs()
    ref = np.load(FIXTURE)
    pred = model.predict(_nchw(images), torch.from_numpy(im_size)).numpy()
    assert_pred_close(pred, ref["pred"])
    out0 = _maps(model, images)[0]
    exact = _maps(model, images, torch.float64)[0]
    fixture_err = _max_err([ref["out0"]], [exact])
    assert 1e-4 < fixture_err <= 5e-6 * np.abs(exact).max()
    assert _max_err([out0], [exact]) <= 2 * fixture_err


# the other recipes, each at its own class count: r18vd is the plain path
# (no DCN, CoordConv, SPP or IoU-aware), 2x_custom the 2x model at 20 classes
# with perturbed offset convs so every DCN interpolates
OTHER_CONFIGS = {"r18vd": (PPYOLO_r18vd_Config, False),
                 "2x_custom": (PPYOLO_2x_Custom_Config, True)}


@pytest.mark.parametrize("name", ["golden", "deformed", "r18vd", "2x_custom"])
def test_fp64_matches_live_jax_x64(jax_model_params, jax_runs, name):
    """In fp64 the port and the JAX package differ only by summation order,
    far below test_golden's tolerances: the head maps at rtol = atol = 1e-4
    and the detections as there.  "deformed" perturbs the offset convs so
    every DCN interpolates.  The other recipes go through ``from_config``
    at their own class counts, held tighter (measured 3.4e-13 and 1.0e-11):
    every map within 1e-9, the labels equal and the fp32 scores and boxes
    within one unit in the last place (the fp64 sums round to fp32 on
    either side of a tie)."""
    images, im_size = _inputs()
    if name in OTHER_CONFIGS:
        make_cfg, deform = OTHER_CONFIGS[name]
        cfg = make_cfg()
        jmodel = JaxPPYOLO.from_config(cfg)
        params = jmodel.init(jax.random.PRNGKey(123))
        params = _perturb_offsets(params) if deform else params
        jpred, jmaps = _jax_forward_x64(jmodel, params, images, im_size)
        model = _port(jax_flatten_tree(params), cfg)
    else:
        _, params = jax_model_params
        jpred, jmaps = jax_runs(name, "fp64")
        model = _port(jax_flatten_tree(_params(params, name)))
    maps = _maps(model, images, torch.float64)
    pred = model.predict(_nchw(images, torch.float64),
                         torch.from_numpy(im_size).double()).numpy()
    for m, jm in zip(maps, jmaps):
        assert m.shape == jm.shape
        if name in OTHER_CONFIGS:
            assert _max_err([m], [jm]) <= 1e-9
        else:
            np.testing.assert_allclose(m, jm, rtol=1e-4, atol=1e-4)
    if name in OTHER_CONFIGS:
        assert (pred[..., 0] >= 0).any()
        np.testing.assert_array_equal(pred[..., 0], jpred[..., 0])
        np.testing.assert_array_max_ulp(pred, jpred, maxulp=1)
    else:
        assert_pred_close(pred, jpred)


def test_fp32_matches_live_jax_with_deformed_offsets(jax_model_params, jax_runs):
    """fp32 port against live fp32 JAX with every DCN interpolating:
    detections at test_golden's tolerances.  The fp32 maps differ by
    summation order alone (the fp64 forwards agree, above), up to ~5e-3 at
    this model's scale, so each level is held through the exact forward:
    the port's fp32 map lies no farther from it than twice the JAX
    package's fp32 map does."""
    _, params = jax_model_params
    jpred, jmaps = jax_runs("deformed", "fp32")
    _, exact = jax_runs("deformed", "fp64")
    images, im_size = _inputs()
    model = _port(jax_flatten_tree(_params(params, "deformed")))
    maps = _maps(model, images)
    pred = model.predict(_nchw(images), torch.from_numpy(im_size)).numpy()
    assert_pred_close(pred, jpred)
    for m, jm, ex in zip(maps, jmaps, exact):
        assert m.shape == jm.shape
        assert _max_err([m], [ex]) <= 2 * _max_err([jm], [ex])


def test_bf16_serving_outputs_match_jax(jax_model_params):
    jmodel, params = jax_model_params
    params = _perturb_offsets(params)
    images, im_size = _inputs()
    jp = jax_optimize(params, precision="bf16", fold_bn=True)
    _, jouts = _jax_forward(jmodel, jp, images.astype(jnp.bfloat16), im_size)
    model = _port(jax_flatten_tree(params))
    sd = optimize_for_inference(model.state_dict(), precision="bf16", fold_bn=True)
    model = model.to(torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(sd)
    outs = [o.float().permute(0, 2, 3, 1).numpy()
            for o in model.outputs(_nchw(images, torch.bfloat16))]
    for o, jo in zip(outs, jouts):
        assert o.shape == jo.shape
        jo = jo.astype(np.float32)
        rel = np.linalg.norm(o - jo) / np.linalg.norm(jo)
        assert rel <= 2e-2, rel


def test_fold_bn_preserves_fp32_outputs(jax_model_params):
    """The fold is exact algebra: in fp64 the folded forward meets the
    unfolded one at rtol = atol = 1e-4.  Folded weights stored in fp32 cost
    one rounding more, so the folded fp32 maps lie no farther from the
    exact forward than twice the unfolded fp32 maps do."""
    _, params = jax_model_params
    flat = jax_flatten_tree(params)
    r = np.random.RandomState(3)
    for k in flat:   # non-trivial BN statistics so the fold does something
        if k.endswith("bn.running_mean"):
            flat[k] = jnp.asarray(r.randn(*flat[k].shape).astype(np.float32) * 0.1)
        elif k.endswith("bn.running_var"):
            flat[k] = jnp.asarray(r.rand(*flat[k].shape).astype(np.float32) + 0.5)
    images = _inputs()[0]
    model = _port(flat)
    unfolded32 = _maps(model, images)
    exact = _maps(model, images, torch.float64)
    model.load_state_dict(optimize_for_inference(model.state_dict(), precision="fp32"))
    for m, ex in zip(_maps(model, images, torch.float64), exact):
        np.testing.assert_allclose(m, ex, rtol=1e-4, atol=1e-4)
    model = _port(flat)
    model.load_state_dict(optimize_for_inference(model.state_dict(), precision="fp32"))
    for m, u, ex in zip(_maps(model, images), unfolded32, exact):
        assert _max_err([m], [ex]) <= 2 * _max_err([u], [ex])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_detector_cpu_predict_batch(jax_model_params):
    from ppyolo_tpu_torch.eval.detector import Detector

    _, params = jax_model_params
    model = _port(jax_flatten_tree(params))
    det = Detector(model, model.state_dict(), _cfg(), precision="bf16", device="cpu")
    imgs = np.random.RandomState(5).randint(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    out = det.predict_batch(imgs, np.array([[480, 640], [96, 96]], np.float32))
    assert out.shape == (2, 100, 6) and np.isfinite(out).all()
    # normalize is op-for-op the JAX Detector's
    x = det.normalize(torch.from_numpy(imgs))
    assert x.dtype == torch.bfloat16 and x.is_contiguous(memory_format=torch.channels_last)
    want = ((imgs.astype(np.float32) / 255.0 - np.array([0.485, 0.456, 0.406], np.float32))
            / np.array([0.229, 0.224, 0.225], np.float32))
    np.testing.assert_allclose(x.float().permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-2, atol=1e-2)
    im, size = det.process_image(np.zeros((30, 40, 3), np.uint8))
    assert im.shape == (1, 608, 608, 3) and size.tolist() == [[30, 40]]


def _jax_bf16_maps(jmodel, params, images, mode):
    """JAX bf16 head maps traced under ``head_decompose(mode)`` (a jit of
    its own per mode: the mode is read while tracing)."""
    from ppyolo_tpu.models.head import head_decompose

    def maps(p, x):
        ctx = Ctx(train=False)
        return jmodel.head.get_outputs(p["head"], jmodel.features(p, x, ctx), ctx)

    with head_decompose(mode):
        outs = jax.jit(maps)(params, jnp.asarray(images.astype(jnp.bfloat16)))
    return [np.asarray(o).astype(np.float32) for o in outs]


def test_bf16_gap_to_jax_is_rounding_order(jax_model_params):
    """The port's bf16 head maps against the JAX package's, under
    ``head_decompose('off')`` (materialized concats, as the port) and the
    serving default ``'auto'`` (the CoordConv and SPP concats summed as
    split convs).  JAX's two modes differ only in those few sums (relative
    L2 0, 2.0e-4, 4.2e-4 by level on these inputs) while the port rounds
    every conv of the network in another order than XLA, so the port lies
    8.1e-3 to 1.4e-2 from both modes, far outside that gap.  What settles
    it: the port's bf16 maps lie as close to the exact (fp64, unfolded)
    forward as JAX's own bf16 maps do (ratio 1.00 to 1.04 by level, held
    at 1.1), so the gap is two bf16 roundings of the same function, not a
    fault; and both stay within the 2e-2 of
    ``test_bf16_serving_outputs_match_jax``."""
    jmodel, params = jax_model_params
    params = _perturb_offsets(params)
    images, _ = _inputs()
    jp = jax_optimize(params, precision="bf16", fold_bn=True)
    off = _jax_bf16_maps(jmodel, jp, images, "off")
    auto = _jax_bf16_maps(jmodel, jp, images, "auto")
    exact = _maps(_port(jax_flatten_tree(params)), images, torch.float64)
    model = _port(jax_flatten_tree(params))
    sd = optimize_for_inference(model.state_dict(), precision="bf16", fold_bn=True)
    model = model.to(torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(sd)
    outs = [o.float().permute(0, 2, 3, 1).numpy()
            for o in model.outputs(_nchw(images, torch.bfloat16))]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for level, (o, f, a, ex) in enumerate(zip(outs, off, auto, exact)):
        gaps = {"port-off": rel(o, f), "port-auto": rel(o, a), "off-auto": rel(f, a),
                "port-exact": rel(o, ex), "off-exact": rel(f, ex), "auto-exact": rel(a, ex)}
        print(f"level {level}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
        assert gaps["port-exact"] <= 1.1 * min(gaps["off-exact"], gaps["auto-exact"]), gaps
        assert max(gaps["port-off"], gaps["port-auto"]) <= 2e-2, gaps
