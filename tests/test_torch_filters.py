"""The port's spatial filters (ops/filters.py) against the JAX package's.

Every function on the same seeded NHWC input, against the JAX function run
eagerly and jitted. Tolerance: 1e-6 relative plus 1e-6 absolute. The port
sums the tap-weighted slices in the JAX package's order but rounds every
product, where XLA's compiled program may contract a product and a sum into
one FMA: the two differ by an ulp or two of the running sum, never by a
different border or tap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import filters as jf
from retinex_tpu_torch.ops import filters as tf

CASES = {
    "gaussian_blur_15": lambda m, x: m.gaussian_blur(x, 15, 0.0),
    "gaussian_blur_5_sigma1.5": lambda m, x: m.gaussian_blur(x, 5, 1.5),
    "laplacian": lambda m, x: m.laplacian(x),
    "sobel_xy": lambda m, x: m.sobel_xy(x),
    "sobel_edge_map": lambda m, x: m.sobel_edge_map(x),
    "box_filter": lambda m, x: m.box_filter(x, 5),
    "box_filter_sum": lambda m, x: m.box_filter(x, 3, normalize=False),
    "uniform_filter_7": lambda m, x: m.uniform_filter(x, 7),
    "uniform_filter_4": lambda m, x: m.uniform_filter(x, 4),
    "forward_diff": lambda m, x: m.forward_diff(x),
    "central_gradient_h": lambda m, x: m.central_gradient(x, 1),
    "central_gradient_w": lambda m, x: m.central_gradient(x, 2),
    "reflect_pad": lambda m, x: m._reflect_pad(x, 3, 2),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("channels", [1, 3])
def test_filter_matches_jax(name, channels):
    x = np.random.default_rng(5).random((2, 40, 56, channels), dtype=np.float32)
    fn = CASES[name]
    got = fn(tf, torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    for want_fn in (lambda v: fn(jf, v), jax.jit(lambda v: fn(jf, v))):
        want = want_fn(jnp.asarray(x))
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ksize,sigma", [(15, 0.0), (5, 1.5), (3, 0.0)])
def test_gaussian_kernel_1d_equals_jax(ksize, sigma):
    got, want = tf.gaussian_kernel_1d(ksize, sigma), jf.gaussian_kernel_1d(ksize, sigma)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
