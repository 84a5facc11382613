"""The port's NHWC u8 Lab-CLAHE (K8 -> K2 -> K8) against the JAX package's.

- ``clahe_rgb_u8_gather`` against the JAX ``clahe_rgb_u8_gather`` in interpret
  mode and against the JAX XLA route ``clahe_lab_rgb(use_pallas=False)``,
  within tests/test_clahe_gather.py:42-43: max 2 levels, under 1e-3 of the
  values off by more than half a level.
- The K8 plain versions are K1's and K3's on permuted tensors, and K2 takes
  a lone plane: its tables of a luma plane equal those of a Lab tensor whose
  L is that plane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops.clahe import clahe_lab_rgb as jax_lab
from retinex_tpu.ops.clahe_gather import clahe_rgb_u8_gather as jax_gather_u8
from retinex_tpu_torch.ops import clahe_gather as cg


@pytest.fixture(scope="module")
def img_u8():
    x = np.random.default_rng(11).random((1, 128, 256, 3), dtype=np.float32) * 0.7
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _assert_clahe_close(got_u8: np.ndarray, want_u8: np.ndarray) -> None:
    d = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    assert d.max() <= 2, f"max diff {d.max()} levels"
    assert (d > 0.5).mean() < 1e-3, f"mismatch fraction {(d > 0.5).mean()}"


@pytest.mark.parametrize("s", [1, 2])
def test_nhwc_pipeline_matches_jax(img_u8, s):
    cg.reset_launches()
    got = cg.clahe_rgb_u8_gather(torch.from_numpy(img_u8), hist_subsample=s).numpy()
    assert got.dtype == np.uint8 and got.shape == img_u8.shape
    assert all(n == 0 for n in cg.LAUNCHES.values())  # plain versions on the CPU
    _assert_clahe_close(got, np.asarray(jax_gather_u8(jnp.asarray(img_u8), interpret=True, hist_subsample=s)))
    xla = jax_lab(jnp.asarray(img_u8.astype(np.float32) / 255.0), use_pallas=False, hist_subsample=s)
    _assert_clahe_close(got, np.round(np.asarray(xla) * 255.0).astype(np.uint8))


def test_nhwc_entry_equals_planar(img_u8):
    x = torch.from_numpy(img_u8)
    planar = cg.clahe_rgb_u8_planar_gather(x.permute(0, 3, 1, 2).contiguous(), hist_subsample=2)
    assert torch.equal(cg.clahe_rgb_u8_gather(x, hist_subsample=2), planar.permute(0, 2, 3, 1))
    assert torch.equal(cg.clahe_rgb_u8_gather(x[0]), cg.clahe_rgb_u8_gather(x)[0])  # HWC squeeze


def test_k8_plain_versions_are_k1_k3_permuted(img_u8):
    x = torch.from_numpy(img_u8)
    xp = x.permute(0, 3, 1, 2).contiguous()
    lab = cg.lab_fwd_u8_nhwc(x)
    assert torch.equal(lab, cg.lab_fwd_u8_plain(xp))
    luts = cg.clahe_tables(lab)
    assert torch.equal(cg.clahe_apply_u8_nhwc(lab, luts), cg.clahe_apply_u8_plain(lab, luts).permute(0, 2, 3, 1))


@pytest.mark.parametrize("s", [1, 2])
def test_tables_of_a_lone_plane(img_u8, s):
    plane = torch.from_numpy(img_u8[..., 1].copy())  # any u8 plane [B, H, W]
    lab = torch.zeros((1, 3, 128, 256), dtype=torch.uint8)
    lab[:, 0] = plane
    lab[:, 1:] = 77
    want = cg.clahe_tables_plain(lab, hist_subsample=s)
    assert torch.equal(cg.clahe_tables_plain(plane, hist_subsample=s), want)
    assert torch.equal(cg.clahe_tables(plane, hist_subsample=s), want)


def test_nhwc_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        cg.lab_fwd_u8_nhwc(torch.zeros((1, 3, 32, 32), dtype=torch.uint8))  # planar, not NHWC
    with pytest.raises(ValueError):
        cg.clahe_tables(torch.zeros((1, 32, 32), dtype=torch.int32))
    with pytest.raises(ValueError):
        cg.clahe_rgb_u8_gather(torch.zeros((1, 40, 32, 3), dtype=torch.uint8))  # 40 % 16 != 0
