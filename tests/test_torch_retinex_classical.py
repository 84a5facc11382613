"""The port's classical Retinex (ops/retinex_classical.py) against the JAX package's.

Every function on the same seeded NHWC input. Tolerances and their reasons:

- The box blur's f32 cumulative sum runs sequentially in PyTorch and as
  XLA's scan in the JAX package: the sums round in another order, so the
  blurred images, and the logs taken of them, agree to a few ulps of the
  running sum: 2e-6 absolute on [0,1] images, 1e-5 on the log-domain
  responses (whose values reach ~5), and 1e-6 relative on the MSRCR colour
  factor (whose values reach ~200).
- The 512-bin quantiles truncate ``(v - min) / range * 512`` to an integer.
  A value that the two sums put on opposite sides of a bin edge moves a
  quantile by 1/512 of the range; on these seeded inputs none does, so the
  quantiles and the stretched outputs are held to 1e-5 as well. A flip would
  show as a jump of range/512, far above that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import retinex_classical as jr
from retinex_tpu_torch.ops import retinex_classical as tr


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(9).random((2, 96, 128, 3), dtype=np.float32)


def _close(got: torch.Tensor, want, atol: float, rtol: float = 0.0) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("sigma", [5.0, 15.0, 80.0, 250.0])
def test_boxes_for_gauss_equal_jax(sigma):
    assert tr._boxes_for_gauss(sigma) == jr._boxes_for_gauss(sigma)


@pytest.mark.parametrize("radius,axis", [(0, 1), (2, 1), (7, 2), (40, 2)])
def test_box_blur_axis(img, radius, axis):
    _close(tr._box_blur_axis(torch.from_numpy(img), radius, axis), jr._box_blur_axis(jnp.asarray(img), radius, axis), 2e-6)


@pytest.mark.parametrize("sigma", [15.0, 80.0])
def test_gaussian_blur_approx(img, sigma):
    _close(tr.gaussian_blur_approx(torch.from_numpy(img), sigma), jr.gaussian_blur_approx(jnp.asarray(img), sigma), 2e-6)


def test_log_domain_responses(img):
    x, xj = torch.from_numpy(img), jnp.asarray(img)
    _close(tr.single_scale_retinex(x, 80.0), jr.single_scale_retinex(xj, 80.0), 1e-5)
    _close(tr.multi_scale_retinex(x), jr.multi_scale_retinex(xj), 1e-5)
    _close(tr.color_restoration(x), jr.color_restoration(xj), 1e-5, rtol=1e-6)


def test_quantiles_and_stretch(img):
    r = np.array(jr.multi_scale_retinex(jnp.asarray(img)))
    lo, hi = tr._quantiles_from_histogram(torch.from_numpy(r), 0.01, 0.99)
    want_lo, want_hi = jr._quantiles_from_histogram(jnp.asarray(r), 0.01, 0.99)
    _close(lo, want_lo, 1e-5)
    _close(hi, want_hi, 1e-5)
    _close(tr.percentile_stretch(torch.from_numpy(r)), jr.percentile_stretch(jnp.asarray(r)), 1e-5)


@pytest.mark.parametrize("mode", ["ssr", "msr", "msrcr"])
def test_enhance_modes(img, mode):
    x, xj = torch.from_numpy(img), jnp.asarray(img)
    if mode == "ssr":
        got, want = tr.ssr_enhance(x), jr.ssr_enhance(xj)
    else:
        got, want = tr.msr_enhance(x, mode=mode), jr.msr_enhance(xj, mode=mode)
    _close(got, want, 1e-5)
    single = tr.ssr_enhance(x[0]) if mode == "ssr" else tr.msr_enhance(x[0], mode=mode)
    assert torch.equal(single, got[0])  # per-image statistics: HWC equals its batch row
