"""The JAX package's CLI and the port's on the JAX package's checkpoint:
``--mode enhance`` (the default route) and ``--mode predict`` with
``--checkpoint tests/fixtures/orbax_jax/latest`` (an Orbax directory,
tests/test_torch_orbax.py) on one in-repo photo at ``--max_size 64``, the
port on the CPU. The PNGs agree within the bounds of the port's CLI tests
against the JAX package: predict within 1 level on under 1e-3 of the bytes
(tests/test_torch_predict.py), enhance within 2 levels on under 1e-3 of
them (tests/test_torch_enhance.py's CLAHE tolerance)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu import cli as jax_cli
from retinex_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "orbax_jax" / "latest"
PHOTO = REPO / "data" / "convergence" / "lowlight_004.png"
KINDS = ("enhanced", "illumination", "comparison")
BOUNDS = {"predict": 1, "enhance": 2}  # levels, on under 1e-3 of the bytes


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("mode", ["predict", "enhance"])
def test_both_clis_agree_on_the_jax_checkpoint(tmp_path, mode, capsys):
    args = ["--mode", mode, "--input_path", str(PHOTO), "--max_size", "64", "--checkpoint", str(FIXTURE)]
    jax_cli.main([*args, "--output_dir", str(tmp_path / "jax")])
    cli.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert f"Loaded checkpoint {FIXTURE} (Orbax)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"{PHOTO.stem}_{k}.png" for k in KINDS)
    for kind in KINDS:
        got, want = _png(tmp_path / "port" / f"{PHOTO.stem}_{kind}.png"), _png(tmp_path / "jax" / f"{PHOTO.stem}_{kind}.png")
        assert got.shape == want.shape
        d = np.abs(got - want)
        what = f"{mode} {kind}: max {d.max()}, {(d > 0).mean():.2e} of bytes differ"
        print(what)
        assert d.max() <= BOUNDS[mode] and (d > 0).mean() < 1e-3, what
