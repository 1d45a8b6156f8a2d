"""The port's strided 3x3 conv (K4's module) against the JAX package, on the CPU.

* fp32: ``conv_s2_phase``, ``conv_s2`` (the plain version on a CPU tensor)
  and ``conv_s2_conv2d`` against ``conv_s2_xla``, ``conv_s2_phase`` and
  ``conv_s2_pallas`` (interpret mode), at rtol = atol = 2e-5, the
  tolerance ``tests/test_ops.py`` holds the JAX variants to.
* bf16: ``conv_s2`` against ``conv_s2_pallas``, max-abs error <= 2^-7 x
  the output's max-abs: both sum bf16 products in fp32 and round once, so
  they lie at most one bf16 ulp apart.
* ``phase_planes`` equals ``_phase_planes`` exactly; odd or non-square
  inputs and tensors that need a gradient raise.
* ``pack_conv_s2_weight`` is the JAX package's HWIO kernel flattened to
  [9*C, Co] (K-major, transposed, for bf16), and a packed weight leaves the
  CPU path exactly ``conv_s2_phase``.
* The probe entry point runs with ``--cpu`` and imports no JAX.
Inputs are made with numpy from a seed and handed to both.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.ops.strided_conv_pallas import (_phase_planes, conv_s2_pallas,
                                                conv_s2_phase as jax_phase, conv_s2_xla)

from ppyolo_tpu_torch.checkpoint.bridge import hwio_to_oihw
from ppyolo_tpu_torch.ops.strided_conv import (conv_s2, conv_s2_conv2d, conv_s2_phase,
                                               pack_conv_s2_weight, phase_planes)

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(2, 24, 16, 32), (1, 38, 64, 48), (2, 8, 8, 8)]   # (N, H, C, Co)
PORT = {"conv_s2_phase": conv_s2_phase, "conv_s2": conv_s2, "conv_s2_conv2d": conv_s2_conv2d}


def _inputs(shape):
    """x NHWC and w HWIO, fp32 numpy."""
    n, h, c, co = shape
    r = np.random.RandomState(sum(shape))
    return (r.randn(n, h, h, c).astype(np.float32),
            (r.randn(3, 3, c, co) * 0.1).astype(np.float32))


def _torch(x, w, dtype):
    """NCHW in channels_last memory, OIHW."""
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dtype).permute(0, 3, 1, 2)
    return xt, torch.from_numpy(hwio_to_oihw(w)).to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_fp32(shape):
    x, w = map(jnp.asarray, _inputs(shape))
    return {"conv_s2_xla": np.asarray(conv_s2_xla(x, w)),
            "conv_s2_phase": np.asarray(jax_phase(x, w)),
            "conv_s2_pallas": np.asarray(conv_s2_pallas(x, w, interpret=True))}


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_matches_jax_variants(shape, port):
    x, w = _inputs(shape)
    got = PORT[port](*_torch(x, w, torch.float32))
    n, h, _, co = shape
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, co, h // 2, h // 2)
    for name, want in _jax_fp32(shape).items():
        np.testing.assert_allclose(_nhwc(got), want, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_within_one_ulp_of_pallas(shape):
    x, w = _inputs(shape)
    want = np.asarray(conv_s2_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                     interpret=True), np.float32)
    got = conv_s2(*_torch(x, w, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    # the padded border (row 0, column 0) is part of the check
    assert np.abs(_nhwc(got) - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_cpu_dispatch_is_the_plain_version():
    x, w = _torch(*_inputs(SHAPES[0]), torch.float32)
    assert torch.equal(conv_s2(x, w), conv_s2_phase(x, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_weight_is_the_hwio_kernel_in_the_kernels_layout(shape, dtype):
    x, w = _inputs(shape)
    _, c, co = shape[1:]
    flat = w.reshape(9 * c, co)   # HWIO flattened: GEMM column k = tap * C + c
    want = torch.from_numpy(np.ascontiguousarray(flat.T if dtype == torch.bfloat16 else flat))
    got = pack_conv_s2_weight(_torch(x, w, torch.float32)[1], dtype)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want.to(dtype))
    assert torch.equal(pack_conv_s2_weight(_torch(x, w, dtype)[1]), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_weight_keeps_the_cpu_path(shape):
    x, w = _inputs(shape)
    for dtype in (torch.float32, torch.bfloat16):
        xt, wt = _torch(x, w, dtype)
        got = conv_s2(xt, wt, packed=pack_conv_s2_weight(wt))
        assert torch.equal(got, conv_s2_phase(xt, wt))
        if dtype == torch.float32:
            np.testing.assert_allclose(_nhwc(got), _jax_fp32(shape)["conv_s2_xla"],
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_planes_equal_jax(shape):
    x, w = _inputs(shape)
    want = _phase_planes(jnp.asarray(x))
    got = phase_planes(_torch(x, w, torch.float32)[0])
    for r in (0, 1):
        for c in (0, 1):
            np.testing.assert_array_equal(_nhwc(got[r][c]), np.asarray(want[r][c]))


@pytest.mark.parametrize("fn", [conv_s2, conv_s2_phase])
@pytest.mark.parametrize("hw", [(9, 9), (8, 10)], ids=["odd", "non-square"])
def test_odd_or_non_square_input_raises(fn, hw):
    x = torch.zeros(1, 8, *hw)
    with pytest.raises(ValueError, match="square input with an even side"):
        fn(x, torch.zeros(8, 8, 3, 3))


def test_input_checks():
    x, w = torch.zeros(1, 8, 8, 8), torch.zeros(16, 8, 3, 3)
    with pytest.raises(ValueError, match="does not match"):
        conv_s2(x, torch.zeros(16, 4, 3, 3))
    with pytest.raises(ValueError, match="not supported"):
        conv_s2(x.half(), w.half())
    # K4 has no backward, as the Pallas kernel has no vjp
    with pytest.raises(RuntimeError, match="no backward"):
        conv_s2(x.requires_grad_(), w)
    with torch.no_grad():
        assert conv_s2(x, w).shape == (1, 16, 4, 4)


def test_kernel_ab_needs_a_card(tmp_path):
    """The A/B of K2 and K4 against an earlier build runs on the card only."""
    from ppyolo_tpu_torch.tools import kernel_ab

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kernel_ab.main(["--earlier", str(tmp_path)])


def test_probe_entry_runs_on_cpu_without_jax():
    code = (
        "import json, sys\n"
        "from ppyolo_tpu_torch.tools.probe_strided_conv import main\n"
        "r = main(['--cpu', '--batch', '1', '--scan', '1', '--disp', '1', '--dtype', 'fp32'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ppyolo_tpu'))\n"
        "print(json.dumps({'result': r, 'bad_imports': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["bad_imports"] == []
    r = got["result"]
    assert r["metric"] == "strided_conv_ab_ms_per_b8_batch" and r["failed"] == []
    for name in ("stage3_0", "stage4_0"):
        assert set(r[name]) == {"conv2d", "phase", "k4", "conv2d#2"}
        assert all(ms > 0 for ms in r[name].values())
    assert "(the plain version: the input lies on the CPU)" in out
