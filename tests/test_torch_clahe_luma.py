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

from fractions import Fraction

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


_TWO23 = np.float32(2.0**23)


def _biased_byte(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K7's and K9's rounding (csrc/clahe_luma.cu::round_biased): the low
    byte of the f32 bits of v + 2^23, and that sum."""
    s = v.astype(np.float32) + _TWO23
    return (s.view(np.uint32) & 0xFF).astype(np.uint8), s


def test_kernel_byte_arithmetic_exhaustive():
    """The kernels' byte arithmetic gives the plain version's bytes over all
    its inputs: a byte b as the f32 with bits 0x4B000000 | b, less 2^23, is
    b; the luma, in [0, 255.5) over all 2^24 RGB triples, rounded by the
    2^23 bias with no clamp is ``_luma_u8``, and its byte + 1 the biased
    value less 2^23 - 1; the gain (y_eq + 1) / (y + 1), its numerator taken
    the same way from the biased y_eq, and the biased rounding of
    min(c * gain, 255) (never negative) are ``_gain_u8`` over all 2^24
    (c, y, y_eq)."""
    b = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal((b | 0x4B000000).view(np.float32) - _TWO23, b.astype(np.float32))
    rgb = _all_triples()
    r, g, bl = (torch.from_numpy(ch.astype(np.float32)) for ch in rgb)
    luma = tl._luma_f32(r, g, bl).numpy()
    assert luma.min() >= 0.0 and luma.max() < 255.5
    y, s = _biased_byte(luma)
    np.testing.assert_array_equal(y, tl._luma_u8(torch.from_numpy(rgb.reshape(1, 3, 4096, 4096))).numpy().reshape(-1))
    np.testing.assert_array_equal(s - np.float32(2.0**23 - 1), y.astype(np.float32) + 1)
    c, yv, y_eq = rgb
    e = y_eq.astype(np.float32) + _TWO23
    gain = (e - np.float32(2.0**23 - 1)) / (yv.astype(np.float32) + np.float32(1.0))
    scaled = c.astype(np.float32) * gain
    assert scaled.min() >= 0.0
    got, _ = _biased_byte(np.minimum(scaled, np.float32(255.0)))
    want = tl._gain_u8(torch.from_numpy(c[None, None]), torch.from_numpy(yv[None]), torch.from_numpy(y_eq[None]))
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))


@pytest.mark.parametrize("cell", [1, 2, 3, 31, 68, 120, 135, 240, 1000])
def test_blend_of_full_luts_stays_under_255_5(cell):
    """The kernels drop the plain blend's clamp to [0, 255]: with all four
    LUT values 255 (the largest) and every x- and y-weight of a cell, the
    three fused multiply-adds (``clahe_fast.blend``'s, unclamped) stay
    below 255.5, so rint already lies in [0, 255]."""
    from retinex_tpu_torch.ops.clahe import _fma
    from retinex_tpu_torch.ops.clahe_fast import _blend_weights

    wt = torch.from_numpy(_blend_weights(cell).reshape(-1))
    xa, ya = wt[:, None], wt[None, :]
    full = torch.full((wt.numel(), wt.numel()), 255.0)
    top = _fma(full, xa, full * (1.0 - xa))
    bot = _fma(full, 1.0 - xa, full * xa)
    out = _fma(top, 1.0 - ya, bot * ya)
    assert float(out.max()) < 255.5 and float(out.min()) > 254.5


@pytest.mark.parametrize("h,w,tiles_y,tiles_x", [(1088, 1920, 8, 8), (128, 256, 8, 8), (120, 252, 6, 6), (64, 96, 4, 2)])
def test_luma_geometry_is_the_plain_blend_maps(h, w, tiles_y, tiles_x):
    """The geometry K7 and K9 read: per column the plain blend's x-weight
    and its two neighbour tiles' LUT offsets, per row its y-weight, bit for
    bit (clahe_fast._cell_maps)."""
    from retinex_tpu_torch.ops.clahe_fast import _cell_maps

    geo = tl.luma_geometry(h, w, tiles_y, tiles_x, "cpu")
    assert geo.dtype == torch.int32 and tuple(geo.shape) == (2 * w + h + 256,)
    t0x, t1x, xa = _cell_maps(w, tiles_x, "cpu")
    ya = _cell_maps(h, tiles_y, "cpu")[2]
    assert torch.equal(geo[:w].view(torch.float32), xa)
    assert torch.equal(geo[w : 2 * w] & 0xFFFF, (t0x * 256).int()) and torch.equal(geo[w : 2 * w] >> 16, (t1x * 256).int())
    assert torch.equal(geo[2 * w : 2 * w + h].view(torch.float32), ya)
    d = np.arange(1, 257, dtype=np.float32)
    np.testing.assert_array_equal(geo[2 * w + h :].numpy().view(np.float32), np.float32(1.0) / d)


def _f32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even."""
    near = np.float32(float(x))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    ties = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return ties[0] if len(ties) == 1 else next(c for c in ties if not int(c.view(np.uint32)) & 1)


def _fma(a, b, c) -> np.float32:
    return _f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_gain_quotient_is_ieee_for_every_pair():
    """K7's and K9's gain: q0 = n * r, q = fma(fma(-d, q0, n), r, q0) with
    r = 1/d from the geometry table equals the IEEE quotient n / d for every
    n = y_eq + 1 and d = y + 1 in 1..256 (fused multiply-adds emulated
    exactly)."""
    rcp = tl.luma_geometry(16, 16, 8, 8, "cpu")[48:].numpy().view(np.float32)
    for d in range(1, 257):
        r = rcp[d - 1]
        for n in range(1, 257):
            nf, df = np.float32(n), np.float32(d)
            q0 = np.float32(nf * r)
            q = _fma(_fma(-df, q0, nf), r, q0)
            assert q == nf / df, (n, d)


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
