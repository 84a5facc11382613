"""The port's luma-gain CLAHE (``clahe_luma``) against the JAX package's.

- ``_luma_u8`` over all 2^24 RGB triples and the gain and rounding over all
  256^3 (c, y, y_eq) are bit-exact against the JAX package's compiled CPU
  program (which contracts the luma's multiply-adds into two FMAs).
- The pipeline (K2 -> K7 plain versions) is held to the XLA oracle
  ``clahe_luma_rgb_u8_xla`` exactly, and to the Pallas pipeline in interpret
  mode within tests/test_clahe_luma.py:38-39 (max 1 level, under 1e-3 of the
  bytes), at hist_subsample 1, 2 and 4.

The CUDA kernels themselves are held to their plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import clahe_luma as jl
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_luma as tl

SHAPE = (2, 128, 256, 3)  # hh=8, hw=16: cell-divisible, small


@pytest.fixture(scope="module")
def img_u8():
    r = np.random.default_rng(11)
    # Dark-skewed so the CLAHE gain is well above 1 on many pixels.
    return np.round((r.random(SHAPE) ** 1.7) * 255.0).astype(np.uint8)


def _all_triples() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255]).astype(np.uint8)  # [3, 2^24]


def test_luma_u8_exhaustive():
    xp = _all_triples().reshape(1, 3, 4096, 4096)
    want = np.asarray(jax.jit(jl._luma_u8)(jnp.asarray(xp)))
    got = tl._luma_u8(torch.from_numpy(xp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gain_and_rounding_exhaustive():
    c, y, y_eq = _all_triples().reshape(3, 1, 1, 4096, 4096)

    @jax.jit
    def jax_gain(c, y, y_eq):  # the expression of jl.clahe_luma_rgb_u8_xla, _RECIP_GAIN=False
        gain = (y_eq.astype(jnp.float32) + 1.0) / (y.astype(jnp.float32) + 1.0)
        return jnp.round(jnp.clip(c.astype(jnp.float32) * gain[:, None], 0.0, 255.0)).astype(jnp.uint8)

    assert not jl._RECIP_GAIN
    want = np.asarray(jax_gain(c, y[:, 0], y_eq[:, 0]))
    got = tl._gain_u8(torch.from_numpy(c), torch.from_numpy(y[:, 0]), torch.from_numpy(y_eq[:, 0])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_pipeline_matches_jax(img_u8, s):
    got = tl.clahe_luma_rgb_u8(torch.from_numpy(img_u8), hist_subsample=s).numpy()
    oracle = np.asarray(jl.clahe_luma_rgb_u8_xla(jnp.asarray(img_u8), hist_subsample=s))
    np.testing.assert_array_equal(got, oracle)
    interp = np.asarray(jl.clahe_luma_rgb_u8(jnp.asarray(img_u8), interpret=True, hist_subsample=s))
    d = np.abs(got.astype(np.int32) - interp.astype(np.int32))
    assert d.max() <= 1, f"s={s}: max diff {d.max()} levels"
    assert (d > 0).mean() < 1e-3, f"s={s}: mismatch fraction {(d > 0).mean()}"


@pytest.mark.parametrize("s", [1, 2])
def test_fused_luma_identical_to_unfused(img_u8, s):
    xp = torch.from_numpy(img_u8).permute(0, 3, 1, 2).contiguous()
    fused = tl.clahe_luma_rgb_u8_planar(xp, fuse_luma=True, hist_subsample=s)
    assert torch.equal(fused, tl.clahe_luma_rgb_u8_planar(xp, hist_subsample=s))
    luts = cg.clahe_tables(tl._luma_u8(xp))
    assert torch.equal(tl.clahe_luma_apply_u8_fused(xp, luts), tl.clahe_luma_apply_u8(xp, tl._luma_u8(xp), luts))


def test_planar_entry_equals_nhwc(img_u8):
    x = torch.from_numpy(img_u8)
    planar = tl.clahe_luma_rgb_u8_planar(x.permute(0, 3, 1, 2).contiguous())
    assert torch.equal(planar.permute(0, 2, 3, 1), tl.clahe_luma_rgb_u8(x))
    assert torch.equal(tl.clahe_luma_rgb_u8(x[0]), tl.clahe_luma_rgb_u8(x)[0])  # HWC squeeze


def test_k7_nhwc_layout_equals_planar(img_u8):
    """K7 takes NHWC as well as planar RGB (the shape tells them apart) and
    returns the input's layout; the luma of either layout is the same plane."""
    x = torch.from_numpy(img_u8)
    xp = x.permute(0, 3, 1, 2).contiguous()
    y = tl._luma_u8(x, dim=3)
    assert y.is_contiguous() and torch.equal(y, tl._luma_u8(xp))
    luts = cg.clahe_tables(y, hist_subsample=2)
    got = tl.clahe_luma_apply_u8(x, y, luts)
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got.permute(0, 3, 1, 2), tl.clahe_luma_apply_u8(xp, y, luts))


@pytest.mark.parametrize("shape", [SHAPE, (1, 101, 217, 3)])
def test_float_entry_routes_match_jax(shape):
    """Cell-divisible shapes take the kernels' chain (plain on the CPU, no
    launch counted); others the plain clahe_luma_rgb_u8_xla. Both equal the
    JAX package's CPU route."""
    x = np.random.default_rng(3).random(shape, dtype=np.float32)
    tl.reset_launches()
    cg.reset_launches()
    got = tl.clahe_luma_rgb(torch.from_numpy(x), hist_subsample=2).numpy()
    want = np.asarray(jl.clahe_luma_rgb(jnp.asarray(x), hist_subsample=2))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == shape
    assert all(n == 0 for n in (*tl.LAUNCHES.values(), *cg.LAUNCHES.values()))


def test_black_and_flat_inputs():
    black = np.zeros((1, 64, 128, 3), np.uint8)
    flat = np.full((1, 64, 128, 3), 100, np.uint8)
    assert not tl.clahe_luma_rgb_u8(torch.from_numpy(black)).any()
    for img in (black, flat):
        got = tl.clahe_luma_rgb_u8(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jl.clahe_luma_rgb_u8_xla(jnp.asarray(img))))


def test_wrappers_validate_inputs():
    xp = torch.zeros((1, 3, 32, 32), dtype=torch.uint8)
    luts = torch.zeros((1, 8, 8, 256), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tl.clahe_luma_apply_u8(xp, torch.zeros((1, 32, 31), dtype=torch.uint8), luts)
    with pytest.raises(ValueError):
        tl.clahe_luma_apply_u8(xp.permute(0, 2, 3, 1).contiguous(), torch.zeros((1, 32, 31), dtype=torch.uint8), luts)
    with pytest.raises(ValueError):
        tl.clahe_luma_apply_u8_fused(xp, luts[:, :, :, :255].contiguous())
    with pytest.raises(ValueError):
        tl.clahe_luma_rgb_u8_planar(torch.zeros((1, 3, 40, 32), dtype=torch.uint8))  # 40 % 16 != 0
    with pytest.raises(ValueError):
        tl.clahe_luma_rgb_u8_planar(xp, hist_subsample=0)
