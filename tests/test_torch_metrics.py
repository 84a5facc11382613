"""The port's metrics (one value per image of a batch) against the JAX package's.

Each metric of ``retinex_tpu_torch/ops/metrics.py`` and ``calculate_metrics``
against ``retinex_tpu.ops.metrics`` run on each image alone, rtol 1e-5
(tests/test_evaluate.py:82), on a seeded batch of three: uniform noise
(std ~0.29, far from 0), a low-light photo crop from data/convergence, and
a nearly flat image (std ~0.01). The reference images are the same plus
seeded noise. entropy's bin edges are jnp.linspace's, bit for bit.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.ops import colorspace as jcs
from retinex_tpu.ops import metrics as jm
from retinex_tpu_torch.ops import colorspace as tcs
from retinex_tpu_torch.ops import metrics as tm

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    h, w = 48, 64
    photo = np.asarray(Image.open(REPO / "data" / "convergence" / "lowlight_005.png").convert("RGB"))
    imgs = np.stack([
        rng.random((h, w, 3)),
        photo[:h, :w] / 255.0,
        0.4 + 0.02 * rng.random((h, w, 3)),
    ]).astype(np.float32)
    refs = np.clip(imgs + rng.normal(0.0, 0.03, imgs.shape), 0.0, 1.0).astype(np.float32)
    refs[2] = imgs[2]  # identical: psnr's 100 dB branch
    return imgs, refs


PAIRED = ("psnr", "ssim", "mse")


@pytest.mark.parametrize("name", ["psnr", "mse", "ssim", "entropy", "niqe_simplified", "saturation", "naturalness"])
def test_metric_matches_jax(batch, name):
    imgs, refs = batch
    args = (imgs, refs) if name in PAIRED else (imgs,)
    got = getattr(tm, name)(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == (len(imgs),)
    want = [float(getattr(jm, name)(*(jnp.asarray(a[i]) for a in args))) for i in range(len(imgs))]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("with_ref", [False, True])
def test_calculate_metrics_matches_jax(batch, with_ref):
    imgs, refs = batch
    got = tm.calculate_metrics(torch.from_numpy(imgs), torch.from_numpy(refs) if with_ref else None)
    for i in range(len(imgs)):
        want = jm.calculate_metrics(jnp.asarray(imgs[i]), jnp.asarray(refs[i]) if with_ref else None)
        assert list(got) == list(want)  # same keys, same order
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k][i]), float(v), rtol=1e-5, err_msg=k)
    assert float(imgs.std()) > 0.1 and float(imgs[2].std()) < 0.02


def test_saturation_map_and_entropy_edges(batch):
    imgs, _ = batch
    x = imgs.copy()
    x[0, :4, :4] = 0.0  # max == 0: saturation 0
    np.testing.assert_array_equal(tcs.saturation_map(torch.from_numpy(x)).numpy(), np.asarray(jcs.saturation_map(jnp.asarray(x))))
    edges = torch.arange(257, dtype=torch.float32) / 256
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jnp.linspace(0.0, 1.0, 257)))
    # Values on the edges, at 0 and at 1 land in np.histogram's bins.
    v = np.concatenate([np.arange(257) / 256, [0.0, 1.0]]).astype(np.float32).reshape(1, 1, -1, 1)
    np.testing.assert_allclose(tm.entropy(torch.from_numpy(v)).numpy(), [float(jm.entropy(jnp.asarray(v[0])))], rtol=1e-6)
