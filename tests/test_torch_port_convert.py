"""The port's weight converter (``ppyolo_tpu_torch/checkpoint/convert.py``)
against the JAX package's (``ppyolo_tpu/checkpoint/convert.py``), on the CPU.

Neither package has real weights here, so the files are fabricated with
seeded values: a reference ``.pt`` under the port's keys (extra keys, one
shape mismatch), and a ``.pdparams`` protocol-2 pickle whose names follow
the JAX model's ``_iter_convs`` and ``paddle_name``s (a ``bytes`` key, the
dygraph sidecar, one missing leaf).  The port's state dict must equal the
JAX converter's tree through the bridge bitwise, skipped leaves included,
for ppyolo_2x and ppyolo_r18vd; the (key, Paddle name) pairs must be the
JAX model's for every config; a ``.pt`` loads through the three entries;
the port's ``convert_weights`` npz equals JAX's ``save_params_npz`` of the
JAX conversion.
"""
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import configs
from ppyolo_tpu.checkpoint import convert as jax_convert
from ppyolo_tpu.checkpoint.io import save_params_npz as jax_save_params_npz
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten, unflatten_tree as jax_unflatten

from ppyolo_tpu_torch.checkpoint import convert
from ppyolo_tpu_torch.checkpoint.bridge import jax_params_to_state_dict, state_dict_to_jax_params
from ppyolo_tpu_torch.checkpoint.io import save_params_npz
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.tools import convert_weights

CONFIGS = ["PPYOLO_2x_Config", "PPYOLO_r18vd_Config"]


def _port_model(cfg):
    return PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))


def _jax_params(sd):
    """The JAX tree of a port state dict (through the bridge: no JAX init)."""
    return jax_unflatten({k: jnp.asarray(v) for k, v in state_dict_to_jax_params(sd).items()})


def _through_bridge(jax_tree, cfg):
    flat = {k: np.asarray(v) for k, v in jax_flatten(jax_tree).items()}
    return jax_params_to_state_dict(flat, PPYOLO.from_config(cfg))


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _seeded(shape, r):
    return r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_pt_conversion_is_the_jax_conversion(name, tmp_path):
    cfg = getattr(configs, name)()
    model = _port_model(cfg)
    base = model.state_dict()
    r = np.random.RandomState(0)
    ref = {k: torch.from_numpy(_seeded(v.shape, r)) for k, v in sorted(base.items())}
    # class-count fine-tuning: the reference's 80-class output conv
    out_w = "head.yolo_output_convs.0.conv.weight"
    ref[out_w] = torch.zeros(ref[out_w].shape[0] + 3, *ref[out_w].shape[1:])
    ref["backbone.stage1_conv1_1.bn.num_batches_tracked"] = torch.tensor(7)
    ref["head.extra_layer.weight"] = torch.ones(2, 2)
    path = str(tmp_path / "ref.pt")
    torch.save(ref, path)

    got = convert.convert_torch_state_dict(convert.load_torch_state_dict(path), model)
    jtree = jax_convert.convert_torch_state_dict(
        jax_convert.load_torch_state_dict(path), _jax_params(base), verbose=False)
    _assert_bitwise(got, _through_bridge(jtree, cfg))
    assert torch.equal(got[out_w], base[out_w])          # the mismatch is skipped
    assert not torch.equal(got["backbone.stage1_conv1_1.conv.weight"],
                           base["backbone.stage1_conv1_1.conv.weight"])
    # the state-dict form of the second argument gives the same
    _assert_bitwise(convert.convert_torch_state_dict(convert.load_torch_state_dict(path), base),
                    got)


def _jax_named_convs(cfg):
    jm = JaxPPYOLO.from_config(cfg)
    return jm, [(c.name, c.paddle_name) for c in jax_convert._iter_convs(jm)]


@pytest.mark.parametrize("index", [0, 1, 2])
def test_paddle_names_are_the_jax_models(index):
    cfg = configs.get_config(index)
    _, want = _jax_named_convs(cfg)
    got = [(k, m.paddle_name) for k, m in convert.iter_named_convs(PPYOLO.from_config(cfg))]
    assert got == want
    assert all(p for _, p in got)


def _fabricated_pdparams(cfg, base, r):
    """{paddle name: OIHW/1-D array} for every leaf the JAX converter reads."""
    jm, named = _jax_named_convs(cfg)
    convs = dict((c.name, c) for c in jax_convert._iter_convs(jm))
    out = {}
    for t, p in named:
        conv = convs[t]
        if p.startswith("yolo_output"):
            pairs = [(f"{t}.conv.weight", f"{p}.weights"), (f"{t}.conv.bias", f"{p}.bias")]
        elif "." in p:
            pairs = [(f"{t}.conv.weight", f"{p}.conv.weights")] + [
                (f"{t}.bn.{leaf}", f"{p}.bn.{ps}") for leaf, ps in
                (("weight", "scale"), ("bias", "offset"), ("running_mean", "mean"),
                 ("running_var", "var"))]
        else:
            bn = "bnv" + p[len("conv"):] if p.startswith("conv1_") else "bn" + p[len("res"):]
            if conv.use_dcn:
                pairs = [(f"{t}.conv.conv_offset.weight", f"{p}_conv_offset.w_0"),
                         (f"{t}.conv.conv_offset.bias", f"{p}_conv_offset.b_0"),
                         (f"{t}.conv.dcn_weight", f"{p}_weights")]
            else:
                pairs = [(f"{t}.conv.weight", f"{p}_weights")]
            pairs += [(f"{t}.bn.{leaf}", f"{bn}_{ps}") for leaf, ps in
                      (("weight", "scale"), ("bias", "offset"), ("running_mean", "mean"),
                       ("running_var", "variance"))]
        for key, pname in pairs:
            out[pname] = _seeded(base[key].shape, r)
    return out


class _Facade:
    """A paddle tensor stand-in: only ``__array__``."""

    def __init__(self, a):
        self.a = a

    def __array__(self, dtype=None, copy=None):
        return self.a if dtype is None else self.a.astype(dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_pdparams_conversion_is_the_jax_conversion(name, tmp_path):
    cfg = getattr(configs, name)()
    model = _port_model(cfg)
    base = model.state_dict()
    pd = _fabricated_pdparams(cfg, base, np.random.RandomState(1))
    missing = "res2a_branch2a_weights"
    del pd[missing]
    first = sorted(pd)[0]
    pd[first.encode()] = pd.pop(first)                          # a Python 2 key
    pd["yolo_transition.0.bn.scale"] = _Facade(pd["yolo_transition.0.bn.scale"])
    pd["StructuredToParameterName@@"] = {"a": "b"}
    path = str(tmp_path / "ppyolo.pdparams")
    with open(path, "wb") as f:
        pickle.dump(pd, f, protocol=2)

    loaded = convert.load_paddle_state_dict(path)
    assert first in loaded and "StructuredToParameterName@@" not in loaded
    got = convert.convert_paddle_state_dict(loaded, model)
    jm = JaxPPYOLO.from_config(cfg)
    jtree = jax_convert.convert_paddle_state_dict(
        jax_convert.load_paddle_state_dict(path), jm, _jax_params(base), verbose=False)
    _assert_bitwise(got, _through_bridge(jtree, cfg))
    key = "backbone.stage2_0.conv1.conv.weight"
    assert torch.equal(got[key], base[key])                     # the missing leaf is kept
    n_changed = sum(not torch.equal(got[k], base[k]) for k in base)
    assert n_changed == len(base) - 1


def test_load_paddle_state_dict_raises_as_jax(tmp_path):
    not_pickle = tmp_path / "a.pdparams"
    not_pickle.write_bytes(b"\x00\x01 not a pickle")
    not_dict = tmp_path / "b.pdparams"
    with open(not_dict, "wb") as f:
        pickle.dump([1, 2, 3], f, protocol=2)
    for path in (not_pickle, not_dict):
        with pytest.raises(ValueError) as want:
            jax_convert.load_paddle_state_dict(str(path))
        with pytest.raises(ValueError) as got:
            convert.load_paddle_state_dict(str(path))
        assert str(got.value) == str(want.value)


def _mini_pt(tmp_path):
    from test_torch_port_train import mini2x_cfg

    cfg = mini2x_cfg()
    sd = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(5)).state_dict()
    r = np.random.RandomState(6)
    sd = {k: (torch.from_numpy((r.randn(*v.shape) * 0.02).astype(np.float32))
              if "conv_offset" in k else v) for k, v in sd.items()}
    pt, npz = str(tmp_path / "mini.pt"), str(tmp_path / "mini.npz")
    torch.save(sd, pt)
    save_params_npz(npz, sd)
    return sd, pt, npz


def test_pt_weights_load_through_the_entries(tmp_path):
    """``.pt`` weights through ``entry.train``, ``entry.eval`` and
    ``entry.demo`` give what the same weights give as an npz."""
    from test_torch_port_entry import entry_cfg
    from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco
    from ppyolo_tpu_torch.entry import demo as demo_entry
    from ppyolo_tpu_torch.entry import eval as eval_entry
    from ppyolo_tpu_torch.entry import train as train_entry

    sd, pt, npz = _mini_pt(tmp_path)
    root = str(tmp_path / "coco")
    anno, img_dir = make_synthetic_coco(root, 4, 2, np.random.RandomState(1),
                                        image_sizes=((96, 128), (128, 96)), box_range=(20, 48))
    dataset = (root, anno, img_dir)
    states = {}
    for path in (pt, npz):
        cfg = entry_cfg(dataset, model_path=path, max_iters=1, save_iter=10, eval_iter=10)
        states[path] = train_entry.run_training(cfg, weights_dir=str(tmp_path / ("w" + path[-3:])),
                                                device="cpu")
    for k, v in states[npz].model.state_dict().items():
        assert torch.equal(states[pt].model.state_dict()[k], v), k

    stats = []
    for path in (pt, npz):
        cfg = entry_cfg(dataset)
        cfg.eval_cfg = dict(cfg.eval_cfg, model_path=path, draw_image=False)
        stats.append(eval_entry.run_eval(cfg, device="cpu",
                                         result_dir=str(tmp_path / ("e" + path[-3:]))))
    np.testing.assert_array_equal(stats[0], stats[1])

    cfg = entry_cfg(dataset)
    cfg.test_cfg = dict(cfg.test_cfg, model_path=pt)
    got = demo_entry.demo_state_dict(cfg, PPYOLO.from_config(cfg))
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("src", ["pt", "pdparams"])
def test_convert_weights_npz_is_jax_save_params_npz(src, tmp_path):
    """``tools/convert_weights`` of a complete file (no leaf left to the
    init) writes the npz that JAX's ``save_params_npz`` writes of the JAX
    conversion, array for array."""
    cfg = configs.get_config(1)
    base = _port_model(cfg).state_dict()
    r = np.random.RandomState(2)
    path = str(tmp_path / f"ref.{src}")
    if src == "pt":
        torch.save({k: torch.from_numpy(_seeded(v.shape, r)) for k, v in sorted(base.items())},
                   path)
        jtree = jax_convert.convert_torch_state_dict(
            jax_convert.load_torch_state_dict(path), _jax_params(base), verbose=False)
    else:
        with open(path, "wb") as f:
            pickle.dump(_fabricated_pdparams(cfg, base, r), f, protocol=2)
        jtree = jax_convert.convert_paddle_state_dict(
            jax_convert.load_paddle_state_dict(path), JaxPPYOLO.from_config(cfg),
            _jax_params(base), verbose=False)
    out, want = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert_weights.main(["--config", "1", "--src", path, "--out", out])
    jax_save_params_npz(want, jtree)
    with np.load(out) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
