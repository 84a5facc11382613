"""The port's fused Lab-CLAHE (K16) against the JAX package's.

``retinex_tpu_torch/ops/clahe_pallas.py::clahe_lab_rgb_pallas`` gets CPU
tensors, so its plain version runs; the JAX side is
``retinex_tpu/ops/clahe_pallas.py::clahe_lab_rgb_pallas`` in interpret mode,
as its own tests run it, on the same numpy image.

Tolerance: that of tests/test_clahe_pallas.py (at most 2 levels, under
1e-3 of the values off by more than half a level). The plain version
computes the JAX function's compiled arithmetic (reciprocal multiplies and
fused multiply-adds); what is left is the power function, whose last bit
differs between libraries and can flip a u8 rounding of a or b. Measured
here: at most 1 level on one value of 73,728 with the defaults, none with
tiles 4 and clip 3.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops.clahe_pallas import clahe_lab_rgb_pallas as jax_clahe_pallas
from retinex_tpu_torch.ops import clahe_pallas as tcp


def _levels(got, want):
    d = np.abs(got - want) * 255.0
    return float(d.max()), float((d > 0.5).mean())


@pytest.mark.parametrize("knobs", [{}, {"tiles_x": 4, "tiles_y": 4, "clip_limit": 3.0}])
def test_plain_matches_pallas_interpret(knobs):
    x = np.random.default_rng(0).random((2, 96, 128, 3), dtype=np.float32)
    want = np.asarray(jax_clahe_pallas(jnp.asarray(x), interpret=True, **knobs))
    tcp.reset_launches()
    got = tcp.clahe_lab_rgb_pallas(torch.from_numpy(x), **knobs).numpy()
    assert got.shape == want.shape
    worst, frac = _levels(got, want)
    print(f"K16 plain vs Pallas interpret {knobs}: max {worst:.3f} levels, {frac:.2e} of values off by > 0.5")
    assert worst <= 2.0 and frac < 1e-3
    assert tcp.LAUNCHES == {"clahe_pallas_hist": 0, "clahe_pallas_apply": 0}


def test_stages_and_layouts():
    """HWC equals NHWC on one image; the two stages compose to the op; the
    histograms count every pixel of its tile; the output is k/255."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, 32, 48, 3), dtype=np.float32) * 1.2 - 0.1)  # clipped to [0, 1]
    out = tcp.clahe_lab_rgb_pallas(x, tiles_x=3, tiles_y=2)
    torch.testing.assert_close(tcp.clahe_lab_rgb_pallas(x[1], tiles_x=3, tiles_y=2), out[1], rtol=0, atol=0)
    lab, hist = tcp.clahe_pallas_hist(x, tiles_y=2, tiles_x=3)
    assert lab.shape == (2, 3, 32, 48) and lab.dtype == torch.uint8
    assert hist.shape == (2, 2, 3, 256) and bool((hist.sum(-1) == 16 * 16).all())
    luts = tcp._luts(hist, 2.0, 32, 48, 2, 3)
    torch.testing.assert_close(tcp.clahe_pallas_apply(lab, luts), out, rtol=0, atol=0)
    k = out * 255.0
    assert bool((out >= 0).all() and (out <= 1).all()) and float((k - torch.round(k)).abs().max()) < 1e-4


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError, match="not divisible"):
        tcp.clahe_lab_rgb_pallas(torch.zeros(1, 57, 41, 3))
    with pytest.raises(ValueError, match="not divisible"):
        tcp.clahe_lab_rgb_pallas(torch.zeros(48, 40, 3), tiles_x=8)  # 40 % 16 != 0
    with pytest.raises(ValueError, match="float32"):
        tcp.clahe_lab_rgb_pallas(torch.zeros(1, 32, 32, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tcp.clahe_pallas_hist(torch.zeros(1, 32, 3, 32).permute(0, 1, 3, 2))
    with pytest.raises(ValueError, match="LUTs"):
        tcp.clahe_pallas_apply(torch.zeros(1, 3, 32, 32, dtype=torch.uint8), torch.zeros(1, 8, 8, 255, dtype=torch.uint8))
    # Off the CPU a wrapper goes to its kernel, which takes CUDA tensors
    # only: it never falls back to the plain version.
    tcp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tcp.clahe_lab_rgb_pallas(torch.zeros(1, 32, 32, 3, device="meta"))
    assert tcp.LAUNCHES == {"clahe_pallas_hist": 0, "clahe_pallas_apply": 0}


def test_jax_rejects_what_the_port_rejects():
    """The contract both packages share: H, W multiples of 2 * tiles."""
    with pytest.raises(ValueError):
        jax_clahe_pallas(jnp.zeros((1, 57, 41, 3), jnp.float32), interpret=True)
    with pytest.raises(ValueError):
        tcp.clahe_lab_rgb_pallas(torch.zeros(1, 57, 41, 3))
