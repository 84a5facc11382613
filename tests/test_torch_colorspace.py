"""The port's colour, resize and letterbox ops against the JAX package's.

Same numpy inputs through both. Tolerances: the rounded u8 Lab agrees on at
least 1 - 1e-4 of values and differs by at most 1 level (cube roots and
powers round differently in the two CPU libraries); float results within
1e-6 (resize) or a few f32 ulps (colour transfer curves).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import colorspace as jcs
from retinex_tpu.ops import letterbox as jlb
from retinex_tpu.ops import resize as jrs
from retinex_tpu_torch.ops import colorspace as tcs
from retinex_tpu_torch.ops import letterbox as tlb
from retinex_tpu_torch.ops import resize as trs
from retinex_tpu_torch.ops.clahe_gather import lab_fwd_u8_plain


def _u8_grid_image(rng) -> np.ndarray:
    """Every 5th level of each channel (52^3 colours) plus random pixels,
    as u8-quantized floats [H, W, 3]."""
    levels = np.arange(0, 256, 5)
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    rand = rng.integers(0, 256, (256 * 64, 3))
    px = np.concatenate([grid, rand]).astype(np.float32)
    px = px[: (len(px) // 256) * 256]
    return (px / 255.0).reshape(-1, 256, 3)


def _assert_u8_close(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"max diff {d.max()}"
    assert (d > 0).mean() <= 1e-4, f"{(d > 0).mean()} of values differ"


def test_rgb_to_lab_u8_matches_jax(rng):
    x = _u8_grid_image(rng)
    want = np.clip(np.round(np.asarray(jcs.rgb_to_lab_u8(jnp.asarray(x)))), 0, 255)
    got = torch.clamp(torch.round(tcs.rgb_to_lab_u8(torch.from_numpy(x))), 0, 255).numpy()
    _assert_u8_close(got, want)


def test_lab_fwd_plain_matches_jax(rng):
    """K1's plain version (de-gamma table, planar u8) is the same Lab."""
    x = _u8_grid_image(rng)
    want = np.clip(np.round(np.asarray(jcs.rgb_to_lab_u8(jnp.asarray(x)))), 0, 255)
    planar = torch.from_numpy(np.round(x * 255.0).astype(np.uint8)).permute(2, 0, 1)[None].contiguous()
    got = lab_fwd_u8_plain(planar)[0].permute(1, 2, 0).numpy()
    _assert_u8_close(got, want)


@pytest.mark.parametrize("dim", [-1, 0])
def test_srgb_bytes_to_lab_u8_matches_jax(rng, dim):
    """The byte form (de-gamma table), channels last as the plain Lab-CLAHE
    route passes them or first, is the JAX package's Lab of the same bytes."""
    x = _u8_grid_image(rng)
    want = np.clip(np.round(np.asarray(jcs.rgb_to_lab_u8(jnp.asarray(x)))), 0, 255)
    rgb = torch.from_numpy(np.round(x * 255.0).astype(np.uint8)).movedim(-1, dim)
    got = tcs.srgb_bytes_to_lab_u8(rgb, dim)
    assert got.dtype == torch.uint8
    _assert_u8_close(got.movedim(dim, -1).numpy(), want)


def test_lab_inverse_and_round_trip(rng):
    x = rng.random((64, 96, 3), dtype=np.float32)
    lab = np.array(jcs.rgb_to_lab_u8(jnp.asarray(x)))
    want = np.asarray(jcs.lab_u8_to_rgb(jnp.asarray(lab)))
    got = tcs.lab_u8_to_rgb(torch.from_numpy(lab)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    back = tcs.lab_u8_to_rgb(tcs.rgb_to_lab_u8(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, atol=2e-4)


def test_transfer_curves_and_luma_match_jax(rng):
    x = rng.random((4096,), dtype=np.float32)
    np.testing.assert_allclose(
        tcs.srgb_to_linear(torch.from_numpy(x)).numpy(), np.asarray(jcs.srgb_to_linear(jnp.asarray(x))), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        tcs.linear_to_srgb(torch.from_numpy(x)).numpy(), np.asarray(jcs.linear_to_srgb(jnp.asarray(x))), rtol=1e-6, atol=1e-7
    )
    img = rng.random((8, 16, 3), dtype=np.float32)
    np.testing.assert_allclose(
        tcs.rgb_to_luma(torch.from_numpy(img)).numpy(), np.asarray(jcs.rgb_to_luma(jnp.asarray(img))), atol=1e-7
    )


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [
        ((64, 96), (32, 48)),  # exact 2x down: the JAX package's _exact_down
        ((64, 96), (16, 24)),  # exact 4x down
        ((63, 99), (21, 33)),  # exact 3x down (odd factor: one source row)
        ((64, 96), (40, 60)),  # non-integer down
        ((16, 24), (64, 96)),  # 4x up (scale2's return path)
        ((4, 6), (64, 96)),  # 16x up (scale3's return path)
    ],
)
def test_resize_bilinear_matches_jax(rng, in_hw, out_hw):
    x = rng.random((2, *in_hw, 3), dtype=np.float32)
    want = np.asarray(jrs.resize_bilinear(jnp.asarray(x), *out_hw))
    got = trs.resize_bilinear(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resize_scale_and_u8_round_match_jax(rng):
    x = rng.random((1, 37, 53, 3), dtype=np.float32)
    for s in (0.5, 0.25):
        want = np.asarray(jrs.resize_scale(jnp.asarray(x), s))
        got = trs.resize_scale(torch.from_numpy(x), s).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
    x = rng.random((1, 64, 96, 3), dtype=np.float32)
    want = np.asarray(jrs.resize_u8_round(jnp.asarray(x), 32, 48))
    got = trs.resize_u8_round(torch.from_numpy(x), 32, 48).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize(
    "hw,new_shape,kw",
    [
        ((1080, 1920), 1920, dict(auto=True, scaleup=False)),
        ((1080, 1920), (1080, 1920), dict(auto=True, scaleup=False)),
        ((480, 640), 256, dict(auto=True, scaleup=False)),
        ((333, 517), 640, dict(auto=False, scaleup=True)),
        ((300, 200), (256, 256), dict(auto=False, scale_fill=True)),
    ],
)
def test_letterbox_matches_jax(rng, hw, new_shape, kw):
    want = jlb.plan_letterbox(*hw, new_shape, **kw)
    got = tlb.plan_letterbox(*hw, new_shape, **kw)
    assert dataclasses_equal(got, want)
    assert (got.out_h, got.out_w) == (want.out_h, want.out_w)
    if hw[0] * hw[1] <= 480 * 640:
        img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
        np.testing.assert_array_equal(tlb.letterbox_np(img, got), jlb.letterbox_np(img, want))


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
