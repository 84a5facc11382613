"""The port's CLAHE against the JAX package's.

- ``clahe_u8`` (any shape), ``_luts_from_hist``, the neighbour/blend tables
  and the cell-divisible plain CLAHE are bit-exact against JAX.
- The K1 -> K2 -> K3 plain chain is held to the Pallas pipeline run in
  interpret mode with the tolerance of tests/test_clahe_gather.py: max 2
  levels, under 1e-3 of values off by more than 0.5 of a level.

The CUDA kernels themselves are held to their plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import clahe as jc
from retinex_tpu.ops import clahe_fast as jf
from retinex_tpu.ops.clahe_gather import clahe_lab_rgb_gather as jax_gather
from retinex_tpu_torch.ops import clahe as tc
from retinex_tpu_torch.ops import clahe_fast as tf
from retinex_tpu_torch.ops import clahe_gather as cg


def _images(rng, shape):
    """A uniform-noise image and a smooth random-walk one (the latter makes
    flat tiles, clipped histograms and exact .5 blend ties)."""
    noise = rng.integers(0, 256, shape)
    walk = np.clip(np.cumsum(rng.integers(-3, 4, shape), axis=-1) + 128, 0, 255)
    return [noise.astype(np.uint8), walk.astype(np.uint8)]


@pytest.mark.parametrize("shape", [(2, 50, 70), (1, 37, 91), (1, 100, 130)])
def test_clahe_u8_bitexact(rng, shape):
    for img in _images(rng, shape):
        want = np.asarray(jc.clahe_u8(jnp.asarray(img)))
        got = tc.clahe_u8(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("area", [64, 1000, 4 * 68 * 120, 4 * 34 * 60])
def test_luts_from_hist_bitexact(rng, area):
    hists = [rng.multinomial(area, np.full(256, 1 / 256), size=8)]
    peaked = np.zeros((4, 256), np.int64)
    peaked[np.arange(4), rng.integers(0, 256, 4)] = area  # a flat tile
    hists.append(peaked)
    hists.append(rng.multinomial(area, rng.dirichlet(np.full(256, 0.05)), size=8))
    for hist in hists:
        want = np.asarray(jf._luts_from_hist(jnp.asarray(hist, jnp.int32), 2.0, area))
        got = tc._luts_from_hist(torch.from_numpy(hist), 2.0, area).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16])
def test_neighbor_and_blend_tables_equal_jax(n):
    for a, b in zip(tf._neighbor_index_tables(n), jf._neighbor_index_tables(n)):
        np.testing.assert_array_equal(a, b)
    for cell in (1, 4, 6, 68, 120, 135):
        got, want = tf._blend_weights(n * cell), jf._blend_weights(n * cell)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 96, 144), (1, 80, 240)])
def test_cell_path_bitexact(rng, shape, s):
    for img in _images(rng, shape):
        want = np.asarray(jf.clahe_u8_fast(jnp.asarray(img), hist_subsample=s))
        got = tf.clahe_u8_fast(torch.from_numpy(img), hist_subsample=s).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 2])
def test_plain_chain_matches_pallas_interpret(s):
    """K1 -> K2 -> K3 plain versions vs the Pallas pipeline in interpret mode."""
    x = np.random.default_rng(7).random((1, 128, 256, 3), dtype=np.float32) * 0.7
    want = np.asarray(jax_gather(jnp.asarray(x), interpret=True, hist_subsample=s))
    got = cg.clahe_lab_rgb_gather(torch.from_numpy(x), hist_subsample=s).numpy()
    d = np.abs(want - got) * 255.0
    assert d.max() <= 2.0, f"max diff {d.max()} levels"
    assert (d > 0.5).mean() < 1e-3, f"mismatch fraction {(d > 0.5).mean()}"


@pytest.mark.parametrize("shape", [(1, 48, 80, 3), (1, 50, 70, 3)])
def test_clahe_lab_rgb_routes_match_jax(shape):
    """Cell-divisible shapes take the kernels' chain (plain on the CPU, so no
    launch is counted), other shapes the plain clahe_u8; both equal the JAX
    package's CPU route."""
    x = np.random.default_rng(3).random(shape, dtype=np.float32)
    cg.reset_launches()
    got = tc.clahe_lab_rgb(torch.from_numpy(x)).numpy()
    want = np.asarray(jc.clahe_lab_rgb(jnp.asarray(x), use_pallas=False))
    np.testing.assert_array_equal(got, want)
    assert all(n == 0 for n in cg.LAUNCHES.values())


def test_wrappers_validate_inputs():
    lab = torch.zeros((1, 3, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cg.lab_fwd_u8(lab.float())
    with pytest.raises(ValueError):
        cg.lab_fwd_u8(torch.zeros((1, 4, 32, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cg.clahe_tables(torch.zeros((1, 3, 40, 32), dtype=torch.uint8))  # 40 % 16 != 0
    with pytest.raises(ValueError):
        cg.clahe_apply_u8(lab, torch.zeros((1, 8, 8, 255), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cg.lab_fwd_u8(lab.transpose(2, 3))  # not contiguous
