"""The port's ``evaluate_directory`` against the JAX package's.

A temp directory of cropped data/convergence PNGs in two sizes, with
same-named, same-sized references for some and a wrong-sized one for
another (no reference row for it). Both functions must give the same rows in
the same order with the same keys, values within the metrics' rtol 1e-5
(tests/test_evaluate.py:82), the same CSV columns, and raise ValueError on
an empty directory. mean_brightness is held to 1e-4: the JAX package's f32
``jnp.mean`` sums in order and lands 1.0e-5 (relative) from the float64
mean of img_2, where the port's mean is within 1e-10 of it.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from retinex_tpu.infer.evaluate import evaluate_directory as jax_evaluate
from retinex_tpu_torch.infer.evaluate import evaluate_directory

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    a, ref = root / "enhanced", root / "reference"
    a.mkdir()
    ref.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(((40, 56), (40, 56), (40, 56), (32, 32), (32, 32))):
        photo = np.asarray(Image.open(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png").convert("RGB"))
        img = np.clip(photo[10 : 10 + h, 20 : 20 + w].astype(np.int32) * 6, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(a / f"img_{i}.png")
        if i in (0, 2, 3):  # same size: a reference
            noisy = np.clip(img.astype(np.int32) + rng.integers(-8, 9, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(noisy).save(ref / f"img_{i}.png")
        if i == 1:  # wrong size: no reference
            Image.fromarray(img[:20]).save(ref / f"img_{i}.png")
    return a, ref


@pytest.mark.parametrize("with_ref", [False, True])
def test_evaluate_matches_jax(dirs, tmp_path, with_ref):
    a, ref = dirs
    ref_dir = str(ref) if with_ref else None
    want = jax_evaluate(str(a), reference_dir=ref_dir, output_csv=str(tmp_path / "jax.csv"), batch_size=2)
    got = evaluate_directory(str(a), reference_dir=ref_dir, output_csv=str(tmp_path / "port.csv"), batch_size=2, device="cpu")
    assert [r["image"] for r in got] == [r["image"] for r in want] == [f"img_{i}.png" for i in range(5)]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k != "image":
                rtol = 1e-4 if k == "mean_brightness" else 1e-5
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"{g['image']} {k}")
    with_psnr = [r["image"] for r in got if "psnr" in r]
    assert with_psnr == (["img_0.png", "img_2.png", "img_3.png"] if with_ref else [])
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}.csv", newline="") as f:
            rows[name] = list(csv.reader(f))
    assert rows["port"][0] == rows["jax"][0]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    assert len(rows["port"][0]) == (10 if with_ref else 7)


def test_evaluate_empty_directory_raises(tmp_path):
    with pytest.raises(ValueError):
        evaluate_directory(str(tmp_path), device="cpu")
