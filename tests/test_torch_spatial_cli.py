"""``--spatial_shard`` through the port's CLI (``retinex_tpu_torch/cli.py``),
on the CPU, as the JAX CLI routes it (``retinex_tpu/cli.py``):

- on one device the flag is ignored: the net prints the JAX line and
  writes the bytes of the run without the flag (the packed default
  included), and ``--classical_mode clahe`` runs with no mesh, the same
  bytes;
- with ``--n_devices 2`` (two CPU shards) a 64-row frame runs the spatial
  forward (the standard net, each frame's rows split over the shards) and
  writes what the one-device standard forward writes, within the float
  noise of the means' summation order; a 72-row frame (72 % 16 != 0) prints
  the JAX package's fallback line and writes the one-device standard
  forward's bytes; ``--classical_mode clahe`` and ``clahe_luma`` run the
  spatial CLAHE, the bytes of one device;
- a directory with the net turns batch sharding off with the JAX line.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from retinex_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
PHOTO = REPO / "data" / "convergence" / "lowlight_000.png"
KINDS = ("enhanced", "illumination", "comparison")
SPATIAL_LINE = "Spatial sharding: H split over 2 devices"
ONE_DEVICE_LINE = "Spatial sharding requested but only one device is visible; ignoring"


def _run(tmp_path, name: str, src: Path, *args) -> dict[str, np.ndarray]:
    out = tmp_path / name
    cli.main(["--mode", "enhance", "--input_path", str(src), "--output_dir", str(out), "--device", "cpu", *args])
    return {k: np.asarray(Image.open(out / f"{src.stem}_{k}.png")).astype(np.int16) for k in KINDS}


def _frame(tmp_path, h: int, w: int = 96) -> Path:
    """A seeded h x w photo (no letterbox padding: both sides are multiples
    of 32 or the frame is taken as it is)."""
    img = np.asarray(Image.open(PHOTO).convert("RGB"))[:h, :w]
    path = tmp_path / f"frame_{h}.png"
    Image.fromarray(np.ascontiguousarray(img)).save(path)
    return path


@pytest.mark.parametrize("args", [[], ["--classical_mode", "clahe"]], ids=["net", "clahe"])
def test_one_device_ignores_the_flag(tmp_path, capsys, args):
    base = ["--max_size", "256", *args]
    want = _run(tmp_path, "plain", PHOTO, *base)
    capsys.readouterr()
    got = _run(tmp_path, "spatial", PHOTO, "--spatial_shard", *base)
    out = capsys.readouterr().out
    assert (ONE_DEVICE_LINE in out) == (not args)
    assert "Using space-to-depth packed inference" in out or args
    for k in KINDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_shards_run_the_spatial_forward(tmp_path, capsys):
    src = _frame(tmp_path, 64)
    want = _run(tmp_path, "plain", src, "--no-packed_inference")
    capsys.readouterr()
    got = _run(tmp_path, "spatial", src, "--spatial_shard", "--n_devices", "2")
    out = capsys.readouterr().out
    assert SPATIAL_LINE in out and "single-device fallback" not in out
    for k in KINDS:
        d = np.abs(got[k] - want[k])
        # The means' summation order moves the net's floats by ~1e-7: a byte
        # crosses a truncation step now and then, and Lab-CLAHE spreads it.
        assert d.max() <= 2 and (d > 0).mean() < 0.02, (k, d.max(), (d > 0).mean())


def test_two_shards_fall_back_on_a_height_off_the_grid(tmp_path, capsys):
    src = _frame(tmp_path, 72)
    want = _run(tmp_path, "plain", src, "--no-packed_inference")
    capsys.readouterr()
    got = _run(tmp_path, "spatial", src, "--spatial_shard", "--n_devices", "2")
    out = capsys.readouterr().out
    assert SPATIAL_LINE in out and "H=72 not divisible by 16; single-device fallback" in out
    for k in KINDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["clahe", "clahe_luma"])
def test_two_shards_run_the_spatial_clahe(tmp_path, capsys, mode):
    base = ["--max_size", "256", "--classical_mode", mode]
    want = _run(tmp_path, "plain", PHOTO, *base)
    got = _run(tmp_path, "spatial", PHOTO, "--spatial_shard", "--n_devices", "2", *base)
    assert "falling back" not in capsys.readouterr().out
    for k in KINDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_directory_turns_batch_sharding_off(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    Image.open(_frame(tmp_path, 64)).save(src / "a.png")
    cli.main(["--mode", "enhance", "--input_path", str(src), "--output_dir", str(tmp_path / "out"), "--device", "cpu",
              "--spatial_shard", "--n_devices", "2", "--batch_size", "1"])
    out = capsys.readouterr().out
    assert "Directory input: spatial sharding handles each chunk; batch-sharding off" in out
    assert SPATIAL_LINE in out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(f"a_{k}.png" for k in KINDS)
