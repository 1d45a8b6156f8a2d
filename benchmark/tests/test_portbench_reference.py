"""The benchmark's plain reference against the port at tiny sizes on the CPU."""
import json
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import model as ref
from benchmark.reference.common import resize_bicubic
from benchmark.reference import train as reftrain

HERE = Path(__file__).resolve().parent
CONFIGS = HERE.parent / "configs"


def fields(name):
    path = HERE / "tiny.json" if name == "tiny" else CONFIGS / f"{name}.json"
    return json.loads(path.read_text())["fields"]


def port_model(cfg):
    from ppyolo_tpu_torch.models import PPYOLO

    return PPYOLO.from_config(SimpleNamespace(**cfg))


@pytest.mark.parametrize("name", ["ppyolo_2x", "ppyolo_r18vd", "tiny"])
def test_param_shapes_are_the_ports_keys(name):
    cfg = fields(name)
    sd = port_model(cfg).state_dict()
    shapes = ref.param_shapes(cfg)
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in shapes)


@pytest.mark.parametrize("name,size", [("tiny", 64), ("ppyolo_r18vd", 96)])
def test_forward_and_detections_match_the_port_in_fp32(name, size):
    from ppyolo_tpu_torch.eval.detector import Detector

    cfg = fields(name)
    P = weights.make_state_dict(ref, cfg, 2 ** 33 + 1, "cpu", size)
    img = torch.randint(0, 256, (2, size, size, 3), generator=torch.Generator().manual_seed(3),
                        dtype=torch.uint8)
    sizes = torch.tensor([[480.0, 640.0], [375.0, 500.0]])
    det = Detector(port_model(cfg), {k: v.clone() for k, v in P.items()},
                   SimpleNamespace(**cfg), target_size=size, precision="fp32", device="cpu")
    with torch.no_grad():
        want = ref.Net(cfg, P)(ref.normalize(cfg, img))
        got = det.model.outputs(det.normalize(img))
        rows, _, _ = ref.detect(cfg, P, img, sizes)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-4
    out = det.predict_batch(img.numpy(), sizes.numpy())
    assert np.array_equal(out[..., 0], rows[..., 0].numpy())
    np.testing.assert_allclose(out[..., 1:], rows[..., 1:].numpy(), rtol=1e-3, atol=1e-2)


def test_resize_matches_cv2_to_one_level():
    r = np.random.default_rng(0)
    f = r.integers(0, 256, (375, 500, 3), dtype=np.uint8)
    want = cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB), (416, 416), interpolation=2)
    got = resize_bicubic(torch.from_numpy(f), 416).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_train_steps_match_the_port_in_fp32():
    """Three fp32 fine-tuning steps of the port (train-mode BN, DropBlock,
    losses, SGD, EMA) against the reference's from the same weights and
    seed, leaf by leaf."""
    from ppyolo_tpu_torch.train.loop import make_unit_step
    from ppyolo_tpu_torch.train.train_step import init_train_state
    from benchmark.harness import traffic
    from benchmark.harness import train as drv

    cfg_file = json.loads((HERE / "tiny.json").read_text())
    t = {"batch": 2, "size": 64, "pool": 3, "max_boxes": 50, "boxes": 4, "freeze_at": 0}
    cfg = drv.train_cfg(cfg_file, t)
    P = weights.make_state_dict(ref, cfg, 99, "cpu", 64)
    pool = traffic.train_batches(t, cfg, 99)
    model = port_model(cfg)
    model.load_state_dict(P)
    model.to(memory_format=torch.channels_last)
    ns = SimpleNamespace(**cfg)
    state = init_train_state(model, ns)
    gen = torch.Generator().manual_seed(drv.drop_seed(99))
    unit = make_unit_step(model, ns, state, gen, capture=False)
    keys = list(state.trainable)
    prog = {"loss": []}
    for i in range(3):
        state, losses = unit(state, {k: torch.from_numpy(v) for k, v in pool[i].items()}, gen)
        prog["loss"].append(float(losses["total_loss"]))
        if i == 0:
            prog["grad"] = {k: float(state.optimizer.bufs[k].norm()) for k in keys}
    stats = {k: b for k, b in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    prog.update(step=drv.norms_from(P, state.trainable), ema=drv.norms_from(P, state.ema),
                bn=drv.norms_from(P, stats))
    refr = reftrain.steps(ref, cfg, P, pool, drop_seed=drv.drop_seed(99),
                          device=torch.device("cpu"))
    r = reftrain.readings(prog, refr)
    assert all(abs(a - b) < 1e-5 * b for a, b in zip(prog["loss"], refr["loss"]))
    assert refr["ema"] and refr["bn"]
    # the worst leaf: a DCN offset bias, whose gradient sums d_offset over
    # the map with much cancellation (5e-4 in fp32 here; K3's plain version
    # and the reference's autograd agree to 1e-15 in fp64)
    for name in ("grad", "step", "ema", "bn"):
        assert r[f"{name}_gap_med"] < 1e-4 and r[f"{name}_gap_max"] < 1e-3, (name, r)
    assert r["step_gap_total"] < 1e-4, r
