"""F3: the byte / 255 (and the Lab white-point divisions) as IEEE division
rounds them, on every device (``colorspace.ieee_div``).

On the CPU, where PyTorch divides, the helper gives numpy's f32 quotient,
and the routes it serves (``adaptive_params.gray_levels``, the plain
Lab-CLAHE route of ``clahe.clahe_lab_rgb``) give the bytes they gave
through the division before. On the card, where PyTorch multiplies by the
reciprocal, tests/test_torch_cuda.py holds them to the CPU over every sRGB
triple.
"""

import numpy as np
import pytest
import torch

from retinex_tpu_torch.infer.adaptive_params import brightness_features, gray_levels
from retinex_tpu_torch.ops import clahe as tc
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops.colorspace import ieee_div, lab_u8_to_rgb, rgb_to_lab_u8, rgb_to_luma


def _cube_nhwc(part: int, parts: int = 4) -> torch.Tensor:
    """One of `parts` slices of every sRGB byte triple / 255, NHWC [1, n, 4096, 3]."""
    v = torch.arange(part * (1 << 24) // parts, (part + 1) * (1 << 24) // parts, dtype=torch.int32)
    rgb = torch.stack([v >> 16, (v >> 8) & 255, v & 255], dim=-1).float()
    return (rgb / 255.0).reshape(1, -1, 4096, 3)


@pytest.mark.parametrize("c", [255.0, 12.92, 0.950456, 1.088754, 116.0, 7.787])
def test_ieee_div_is_the_f32_quotient(c):
    """Every byte, and 1M floats of several magnitudes, divided by the port's
    divisors: numpy's f32 quotient (the divisor taken as its f32 value)."""
    rng = np.random.default_rng(int(c * 1000))
    vals = [np.arange(256, dtype=np.float32),
            (rng.random(1 << 20) * 10.0 ** rng.integers(-6, 7, 1 << 20)).astype(np.float32)]
    for v in vals:
        got = ieee_div(torch.from_numpy(v), c).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), (v / np.float32(c)).view(np.int32))


@pytest.mark.parametrize("part", range(4))
def test_gray_and_plain_lab_bytes_unchanged_over_every_srgb_triple(part):
    """On the CPU the gray levels (brightness_features, the saliency map)
    and the plain route's quantisation + Lab bytes, now through ieee_div and
    K1's plain version (its de-gamma table), equal the expressions they
    replaced, over every sRGB triple (a quarter per case)."""
    x = _cube_nhwc(part)
    old_gray = torch.round(rgb_to_luma(torch.round(x * 255.0) / 255.0) * 255.0)
    assert torch.equal(gray_levels(x), old_gray)
    xq = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
    old_lab = torch.clamp(torch.round(rgb_to_lab_u8(xq)), 0, 255).to(torch.uint8)
    assert torch.equal(cg.lab_fwd_f32_nhwc_plain(x).permute(0, 2, 3, 1), old_lab)


@pytest.mark.parametrize("shape", [(1, 37, 91), (2, 60, 100)])
def test_plain_lab_clahe_route_unchanged(shape):
    """clahe_lab_rgb on frames that are not cell-divisible (its plain route)
    gives the floats of the expression chain it replaced, and
    brightness_features the same features, on the CPU: seeded frames past
    [0, 1] with exact .5 ties."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape + (3,), dtype=np.float32) * np.float32(1.2) - np.float32(0.1)
    x.reshape(-1)[::7] = (rng.integers(0, 255, x.reshape(-1)[::7].size) + 0.5) / 255.0
    xt = torch.from_numpy(x)
    assert not tc.cell_divisible(shape[1], shape[2], 8, 8)
    xq = torch.round(torch.clamp(xt, 0.0, 1.0) * 255.0) / 255.0
    lab = torch.clamp(torch.round(rgb_to_lab_u8(xq)), 0, 255).to(torch.uint8)
    l_eq = tc.clahe_u8(lab[..., 0])
    lab_eq = torch.stack([l_eq.float(), lab[..., 1].float(), lab[..., 2].float()], dim=-1)
    want = torch.round(lab_u8_to_rgb(lab_eq) * 255.0) / 255.0
    assert torch.equal(tc.clahe_lab_rgb(xt), want)
    old = torch.round(rgb_to_luma(torch.round(xt * 255.0) / 255.0) * 255.0)
    feats = brightness_features(xt)
    assert torch.equal(feats["mean_brightness"], old.mean() / 255.0)
    assert torch.equal(feats["dark_pixel_ratio"], (old < 50.0).float().mean())
