"""Deformable PSROI pooling in the port (``ppyolo_tpu_torch/ops/
deform_psroi_pool.py``) against the JAX function and the numpy oracle of
``tests/test_psroi.py`` (a transliteration of the reference CUDA kernel),
on the CPU.

The port takes NCHW input and gives [R, D, p, p]; the JAX function is
NHWC.  Forward in fp32: bitwise the JAX function in every case measured
(held at 1e-6), and within the oracle test's 1e-4 of the oracle.
Gradients against ``jax.grad`` in fp32 at 1e-5 (the JAX function is fp32
inside whatever its input).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.ops.deform_psroi_pool import deform_psroi_pool as jax_psroi

from ppyolo_tpu_torch.ops.deform_psroi_pool import deform_psroi_pool

from test_psroi import _oracle

ROIS = np.array([[0, 2, 3, 9, 10], [1, 0, 0, 13, 11], [0, -5, 4, 30, 6],
                 [1, 6.5, 2.5, 6.5, 2.5]], np.float32)   # out of bounds; a point ROI


def _case(classes, seed=0, output_dim=4, group=2, pooled=3):
    """x NHWC, rois, trans [R, p, p, 2K] (None for 0 classes) and the kwargs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 12, 14, output_dim * group * group).astype(np.float32)
    trans = (None if classes == 0
             else rng.randn(len(ROIS), pooled, pooled, 2 * classes).astype(np.float32) * 0.5)
    kw = dict(spatial_scale=0.5, output_dim=output_dim, group_size=group, pooled_size=pooled,
              part_size=pooled, sample_per_part=2, trans_std=0.1)
    return x, trans, kw


def _port(x, trans, kw, dtype=torch.float32):
    return deform_psroi_pool(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
                             torch.from_numpy(ROIS).to(dtype),
                             None if trans is None else torch.from_numpy(trans).to(dtype), **kw)


@pytest.mark.parametrize("classes", [0, 1, 2, 4])
def test_psroi_matches_jax_and_the_oracle(classes):
    x, trans, kw = _case(classes)
    got = _port(x, trans, kw).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_psroi(jnp.asarray(x), jnp.asarray(ROIS),
                                None if trans is None else jnp.asarray(trans), **kw))
    assert got.shape == want.shape == (len(ROIS), 3, 3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = _oracle(x, ROIS, trans, kw["spatial_scale"], kw["output_dim"], kw["group_size"],
                  kw["pooled_size"], kw["part_size"], kw["sample_per_part"], kw["trans_std"])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_psroi_other_sizes_and_channels_last_input():
    """pooled 7 over part 4 and groups of 7 (an R-FCN layout at a small
    size), four samples a bin, and an input in channels_last memory."""
    rng = np.random.RandomState(3)
    d, g, p = 3, 7, 7
    x = rng.randn(1, 10, 9, d * g * g).astype(np.float32)
    trans = rng.randn(len(ROIS), 4, 4, 2 * 3).astype(np.float32) * 0.3
    kw = dict(spatial_scale=0.75, output_dim=d, group_size=g, pooled_size=p, part_size=4,
              sample_per_part=4, trans_std=0.2)
    rois = ROIS.copy()
    rois[:, 0] = 0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = deform_psroi_pool(xt, torch.from_numpy(rois), torch.from_numpy(trans), **kw)
    want = np.asarray(jax_psroi(jnp.asarray(x), jnp.asarray(rois), jnp.asarray(trans), **kw))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("classes", [0, 2])
def test_psroi_gradients_match_jax_grad(classes):
    """The JAX function computes in fp32 whatever its input (``f32`` casts
    throughout), so its gradient is held in fp32: the port's autograd
    gradient within 1e-5 of ``jax.grad``'s (the same expression, summed in
    another order)."""
    x, trans, kw = _case(classes, seed=1)
    cot = np.random.RandomState(2).randn(len(ROIS), 3, 3, 4).astype(np.float32)

    def loss(x_, t_):
        return jnp.sum(jax_psroi(x_, jnp.asarray(ROIS), t_, **kw) * jnp.asarray(cot))

    if trans is None:
        jgx, jgt = np.asarray(jax.grad(lambda a: loss(a, None))(jnp.asarray(x))), None
    else:
        jgx, jgt = (np.asarray(g) for g in
                    jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(trans)))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tt = None if trans is None else torch.from_numpy(trans).requires_grad_()
    out = deform_psroi_pool(tx, torch.from_numpy(ROIS), tt, **kw)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert np.abs(jgx).max() > 0
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, rtol=1e-5, atol=1e-5)
    if trans is not None:
        assert np.abs(jgt).max() > 0
        np.testing.assert_allclose(tt.grad.numpy(), jgt, rtol=1e-5, atol=1e-5)
