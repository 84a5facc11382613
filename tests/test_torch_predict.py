"""The port's predict route, its CLI, evaluate's CLI and the simple-enhance
entry point.

- ``predict_single_image`` and ``predict_batch`` against the JAX package's,
  same weights (the standard forward, jitted on the JAX side), at
  max_size=128: the illumination within 2e-5 as floats, the PNGs within 1
  level on under 1e-3 of the bytes.
- ``predict_batch``'s PNGs equal ``predict_single_image``'s on the CPU.
- ``--mode predict --device cpu`` with a ``torch.save``d ``.pth`` writes the
  PNGs for a file and a directory, and raises FileNotFoundError without a
  checkpoint; ``--mode evaluate --device cpu`` writes ``metrics.csv``;
  ``simple_enhance_main --device cpu`` writes three PNGs.
"""

import csv
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.infer.enhance import load_image as jax_load_image
from retinex_tpu.infer.predict import predict_batch as jax_predict_batch
from retinex_tpu.infer.predict import predict_single_image as jax_predict_single
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu_torch import cli
from retinex_tpu_torch.infer.predict import predict_batch, predict_single_image
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

REPO = Path(__file__).resolve().parent.parent
PHOTO = REPO / "data" / "convergence" / "lowlight_006.png"
KINDS = ("enhanced", "illumination", "comparison")


@pytest.fixture(scope="module")
def same_weights():
    """(jitted JAX apply, port apply) of one untrained net."""
    model = JaxNet(use_preact=False, use_aspp=False)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = MultiScaleUPRetinex(use_preact=False, use_aspp=False).eval()
    port.load_state_dict(variables_to_state_dict(variables, False, False))

    def port_apply(batch):
        with torch.inference_mode():
            return port(batch)

    return jax.jit(lambda b: model.apply(variables, b, train=False)), port_apply


@pytest.fixture(scope="module")
def photo_dir(tmp_path_factory):
    """Three photos on one 96x128 canvas at max_size 128."""
    d = tmp_path_factory.mktemp("photos")
    for i in (6, 7, 8):
        Image.open(REPO / "data" / "convergence" / f"lowlight_{i:03d}.png").convert("RGB").resize((128, 96)).save(
            d / f"lowlight_{i:03d}.png"
        )
    return d


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


def _assert_pngs_close(got_dir, want_dir, stems):
    for stem in stems:
        for kind in KINDS:
            d = np.abs(_png(got_dir / f"{stem}_{kind}.png") - _png(want_dir / f"{stem}_{kind}.png"))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, f"{stem}_{kind}: max {d.max()}, {(d > 0).mean():.2e} off"


def test_predict_single_image_matches_jax(tmp_path, same_weights):
    jax_apply, port_apply = same_weights
    jax_predict_single(jax_apply, str(PHOTO), str(tmp_path / "jax"), max_size=128)
    _enh, illu, _ = predict_single_image(port_apply, str(PHOTO), str(tmp_path / "port"), max_size=128, device="cpu")
    img, _ = jax_load_image(str(PHOTO), 128)
    want_illu = np.asarray(jax_apply(jnp.asarray(img)[None])[2][0])
    assert illu.shape == want_illu.shape
    np.testing.assert_allclose(illu.numpy(), want_illu, atol=2e-5)
    _assert_pngs_close(tmp_path / "port", tmp_path / "jax", [PHOTO.stem])


def test_predict_batch_matches_jax_and_single_images(tmp_path, same_weights, photo_dir):
    jax_apply, port_apply = same_weights
    stems = sorted(p.stem for p in photo_dir.iterdir())
    jax_predict_batch(jax_apply, str(photo_dir), str(tmp_path / "jax"), max_size=128, batch_size=3)
    timings = predict_batch(port_apply, str(photo_dir), str(tmp_path / "port"), max_size=128, batch_size=2, device="cpu")
    assert len(timings) == 3
    _assert_pngs_close(tmp_path / "port", tmp_path / "jax", stems)
    for stem in stems:
        predict_single_image(port_apply, str(photo_dir / f"{stem}.png"), str(tmp_path / "single"), max_size=128, device="cpu")
        for kind in KINDS:
            np.testing.assert_array_equal(
                _png(tmp_path / "port" / f"{stem}_{kind}.png"), _png(tmp_path / "single" / f"{stem}_{kind}.png"),
                err_msg=f"{stem}_{kind}",
            )


def test_cli_predict_and_evaluate_on_cpu(tmp_path, photo_dir):
    ckpt = tmp_path / "model.pth"
    model = cli.init_untrained(MultiScaleUPRetinex(False, False), seed=3)
    torch.save({"epoch": 0, "model_state_dict": model.state_dict()}, ckpt)
    base = ["--mode", "predict", "--checkpoint", str(ckpt), "--max_size", "64", "--device", "cpu"]
    out = tmp_path / "pred"
    cli.main([*base, "--input_path", str(PHOTO), "--output_dir", str(out)])
    cli.main([*base, "--input_path", str(photo_dir), "--output_dir", str(out), "--batch_size", "2", "--num_workers", "2"])
    stems = sorted({PHOTO.stem} | {p.stem for p in photo_dir.iterdir()})
    assert sorted(os.listdir(out)) == sorted(f"{s}_{k}.png" for s in stems for k in KINDS)
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        cli.main([*base[:2], "--checkpoint", str(tmp_path / "missing.pth"), "--input_path", str(PHOTO), "--device", "cpu"])

    ev = tmp_path / "eval"
    cli.main(["--mode", "evaluate", "--input_path", str(out), "--test_dir", str(out), "--output_dir", str(ev), "--device", "cpu"])
    with open(ev / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["image"] for r in rows] == sorted(os.listdir(out))
    assert list(rows[0]) == ["image", "mean_brightness", "contrast", "entropy", "niqe", "saturation", "naturalness",
                             "psnr", "ssim", "mse"]
    assert all(float(r["psnr"]) == 100.0 for r in rows)  # each image is its own reference


def test_simple_enhance_on_cpu(tmp_path):
    out = tmp_path / "simple"
    cli.simple_enhance_main(["--input", str(PHOTO), "--output", str(out), "--max_size", "64", "--device", "cpu"])
    assert sorted(os.listdir(out)) == sorted(f"{PHOTO.stem}_{k}.png" for k in KINDS)
