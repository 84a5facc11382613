"""The port's space-to-depth transforms against the JAX package's.

Same numpy inputs through ``retinex_tpu/ops/s2d.py`` and
``retinex_tpu_torch/ops/s2d.py``. Layout moves, packers, the max pool and
the phase matrices are exact; the convolutions and the matrix-product
upsample agree within atol 1e-6 (float reassociation on values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import s2d as js
from retinex_tpu_torch.ops import s2d as ts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 4, 6, 32), (3, 2, 2, 1)])
def test_s2d_and_d2s_match_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    packed = ts.s2d(_t(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(js.s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(ts.d2s(packed).numpy(), x)
    y = rng.standard_normal((shape[0], shape[1], shape[2], 4 * shape[3])).astype(np.float32)
    np.testing.assert_array_equal(ts.d2s(_t(y)).numpy(), np.asarray(js.d2s(jnp.asarray(y))))


@pytest.mark.parametrize(
    "k,dilation,cin,cout",
    [(1, 1, 4, 6), (3, 1, 3, 32), (3, 1, 32, 32), (3, 2, 32, 32), (5, 1, 2, 3), (7, 1, 2, 1)],
)
def test_pack_kernel_s1_matches_jax(rng, k, dilation, cin, cout):
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    got = ts.pack_kernel_s1(kern, dilation=dilation)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(js.pack_kernel_s1(jnp.asarray(kern), dilation=dilation)))


@pytest.mark.parametrize("k,cin,cout", [(1, 32, 64), (3, 32, 64), (3, 64, 128), (5, 3, 4)])
def test_pack_kernel_s2_matches_jax(rng, k, cin, cout):
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    np.testing.assert_array_equal(ts.pack_kernel_s2(kern), np.asarray(js.pack_kernel_s2(jnp.asarray(kern))))


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 3), (96, 32), (1, 1)])
def test_pack_pointwise_matches_jax(rng, cin, cout):
    kern = rng.standard_normal((1, 1, cin, cout)).astype(np.float32)
    np.testing.assert_array_equal(ts.pack_pointwise(kern), np.asarray(js.pack_pointwise(jnp.asarray(kern))))


def _packed_kernel(kind, rng, cin, cout):
    kern = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    if kind == "s1":
        return js.pack_kernel_s1(kern), cout
    if kind == "s1_dil2":
        return js.pack_kernel_s1(kern, dilation=2), cout
    if kind == "s2":
        return js.pack_kernel_s2(kern), cout
    return js.pack_pointwise(kern[1:2, 1:2]), cout


@pytest.mark.parametrize("kind", ["s1", "s1_dil2", "s2", "pointwise"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_s2d_matches_jax(rng, kind, with_bias):
    x = rng.standard_normal((2, 6, 10, 4 * 8)).astype(np.float32)
    kp, cout = _packed_kernel(kind, rng, 8, 8)
    bias = rng.standard_normal((cout,)).astype(np.float32) if with_bias else None
    want = js.conv_s2d(jnp.asarray(x), kp, None if bias is None else jnp.asarray(bias))
    got = ts.conv_s2d(_t(x), np.asarray(kp), None if bias is None else _t(bias))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 5, 7, 4 * 3), (1, 1, 1, 4), (1, 8, 6, 128)])
def test_maxpool3x3_s1_s2d_matches_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)  # negatives too: -inf padding
    got = ts.maxpool3x3_s1_s2d(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.maxpool3x3_s1_s2d(jnp.asarray(x))))


@pytest.mark.parametrize("n_out,n_in,factor", [(8, 4, 4), (32, 4, 16), (6, 3, 4), (5, 5, 2)])
def test_phase_matrix_matches_jax(n_out, n_in, factor):
    for q in (0, 1):
        np.testing.assert_array_equal(
            ts._phase_matrix(n_out, n_in, factor, q), np.asarray(js._phase_matrix(n_out, n_in, factor, q))
        )


@pytest.mark.parametrize("factor,shape", [(2, (2, 5, 7, 3)), (4, (1, 6, 10, 32)), (16, (2, 3, 4, 32))])
def test_s2d_upsample_mxu_matches_jax(rng, factor, shape):
    g = rng.random(shape, dtype=np.float32)
    want = js.s2d_upsample_mxu(jnp.asarray(g), factor, mode=1)
    got = ts.s2d_upsample_mxu(_t(g), factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_s2d_upsample_mxu_rejects_odd_factor():
    with pytest.raises(ValueError, match="even"):
        ts.s2d_upsample_mxu(torch.zeros(1, 2, 2, 1), 3)
