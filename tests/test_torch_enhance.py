"""The port's enhance route end to end, its CLI, and its isolation.

- ``enhance_single_image`` against the JAX package's on a data/convergence
  photo, same weights (max_size=128): illumination atol 2e-5; the enhanced
  image within the CLAHE tolerance of tests/test_clahe_gather.py (max 2
  levels, under 1e-3 of values off by more than 0.5 of a level).
- The CLI with ``--device cpu`` writes the three PNGs, on the standard route
  and on the default (packed) one; the packed net agrees with the standard
  one within tests/test_packed_inference.py's tolerances.
- The content-aware and multi-scale enhancers and the five classical modes
  against the JAX package's on the same photo: the CLAHE modes identical;
  ssr/msr/msrcr within 1e-5 (the box blur's cumulative sums round in
  another order, tests/test_torch_retinex_classical.py); the enhancers
  within the net's tolerance above.
- The CLI writes the three PNGs on every enhance route, for a file and a
  directory; the routes the port does not run raise.
- No module of the port imports jax or retinex_tpu.
- The entry points raise without a GPU unless the caller asks for the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.infer.enhance import enhance_single_image as jax_enhance
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

REPO = Path(__file__).resolve().parent.parent
PHOTO = REPO / "data" / "convergence" / "lowlight_003.png"


@pytest.fixture(scope="module")
def same_weights():
    """(jitted JAX apply, port apply) of one untrained net."""
    model = JaxNet(use_preact=False, use_aspp=False)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def jax_apply(batch):
        return model.apply(variables, batch, train=False)

    port = MultiScaleUPRetinex(use_preact=False, use_aspp=False).eval()
    port.load_state_dict(variables_to_state_dict(variables, False, False))

    def port_apply(batch):
        with torch.inference_mode():
            return port(batch)

    return jax.jit(jax_apply), port_apply


def _assert_net_close(got_enh, got_illu, want_enh, want_illu):
    assert got_enh.shape == want_enh.shape == (128, 128, 3)
    np.testing.assert_allclose(got_illu.numpy(), np.asarray(want_illu), atol=2e-5)
    d = np.abs(got_enh.numpy() - np.asarray(want_enh)) * 255.0
    assert d.max() <= 2.0, f"max diff {d.max()} levels"
    assert (d > 0.5).mean() < 1e-3, f"mismatch fraction {(d > 0.5).mean()}"


def test_enhance_matches_jax_pipeline(tmp_path, same_weights):
    jax_apply, port_apply = same_weights
    want_enh, want_illu, _ = jax_enhance(jax_apply, str(PHOTO), str(tmp_path), max_size=128, save_outputs=False)
    got_enh, got_illu, _ = enhance_single_image(
        port_apply, str(PHOTO), str(tmp_path), max_size=128, save_outputs=False, device="cpu"
    )
    _assert_net_close(got_enh, got_illu, want_enh, want_illu)


@pytest.mark.parametrize("knob", ["enable_content_aware", "enable_multi_scale"])
def test_enhancers_match_jax(tmp_path, same_weights, knob):
    jax_apply, port_apply = same_weights
    want = jax_enhance(jax_apply, str(PHOTO), str(tmp_path), max_size=128, save_outputs=False, **{knob: True})
    got = enhance_single_image(port_apply, str(PHOTO), str(tmp_path), max_size=128, save_outputs=False, device="cpu", **{knob: True})
    _assert_net_close(got[0], got[1], want[0], want[1])


@pytest.mark.parametrize("mode", ["ssr", "msr", "msrcr", "clahe", "clahe_luma"])
def test_classical_modes_match_jax(tmp_path, mode):
    knobs = dict(classical_mode=mode, max_size=128, save_outputs=False, clip_limit=3.0, tiles=4, hist_subsample=2)
    want_enh, want_illu, _ = jax_enhance(None, str(PHOTO), str(tmp_path), **knobs)
    got_enh, got_illu, _ = enhance_single_image(None, str(PHOTO), str(tmp_path), device="cpu", **knobs)
    np.testing.assert_array_equal(got_illu.numpy(), np.asarray(want_illu))
    if mode.startswith("clahe"):
        np.testing.assert_array_equal(got_enh.numpy(), np.asarray(want_enh))
    else:
        np.testing.assert_allclose(got_enh.numpy(), np.asarray(want_enh), rtol=0, atol=1e-5)


def test_cli_enhance_on_cpu_writes_three_pngs(tmp_path):
    out = tmp_path / "out"
    cli.main([
        "--mode", "enhance", "--input_path", str(PHOTO), "--output_dir", str(out),
        "--max_size", "96", "--no-packed_inference", "--device", "cpu",
    ])
    for kind in ("enhanced", "illumination", "comparison"):
        assert (out / f"{PHOTO.stem}_{kind}.png").is_file()


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "retinex_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'retinex_tpu' or m.startswith('retinex_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "retinex_tpu_torch.cli" in modules and "retinex_tpu_torch.ops.clahe_gather" in modules


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    apply_fn = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enhance_single_image(apply_fn, str(PHOTO), str(tmp_path), max_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "enhance", "--input_path", str(PHOTO), "--no-packed_inference"])
    enh, _, _ = enhance_single_image(apply_fn, str(PHOTO), str(tmp_path), max_size=64, save_outputs=False, device="cpu")
    assert enh.device.type == "cpu"


def test_cli_default_packed_route_on_cpu(tmp_path):
    """The default CLI (packed inference, no flag) writes the three PNGs; its
    net agrees with the standard forward on the same seeded weights and the
    CLI's letterboxed input, within tests/test_packed_inference.py's
    tolerances."""
    out = tmp_path / "out"
    cli.main([
        "--mode", "enhance", "--input_path", str(PHOTO), "--output_dir", str(out),
        "--max_size", "96", "--device", "cpu",
    ])
    for kind in ("enhanced", "illumination", "comparison"):
        assert (out / f"{PHOTO.stem}_{kind}.png").is_file()

    img, _ = load_image(str(PHOTO), 96)
    x = torch.from_numpy(img)[None]
    cpu = torch.device("cpu")
    packed = cli.build_apply_fn(Config(mode="enhance", device="cpu"), cpu)(x)
    standard = cli.build_apply_fn(Config(mode="enhance", packed_inference=False, device="cpu"), cpu)(x)
    for got, want, tol in zip(packed, standard, (2e-3, 2e-3, 2e-5)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol)


ROUTES = {
    "net": [],
    "content_aware": ["--content_aware"],
    "multi_scale": ["--multi_scale"],
    **{m: ["--classical_mode", m] for m in ("ssr", "msr", "msrcr", "clahe", "clahe_luma")},
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_routes_write_three_pngs(tmp_path, route):
    """Every enhance route on a file and on a directory (two images, two
    canvases, --batch_size 1)."""
    src = tmp_path / "in"
    src.mkdir()
    for i, size in ((3, (64, 48)), (4, (48, 64))):
        photo = REPO / "data" / "convergence" / f"lowlight_{i:03d}.png"
        Image.open(photo).convert("RGB").resize(size).save(src / photo.name)
    base = ["--mode", "enhance", "--output_dir", str(tmp_path / "out"), "--device", "cpu", "--clahe_hist_subsample", "2"]
    cli.main([*base, "--input_path", str(PHOTO), "--max_size", "64", *ROUTES[route]])
    cli.main([*base, "--input_path", str(src), "--batch_size", "1", "--num_workers", "2", *ROUTES[route]])
    stems = (PHOTO.stem, "lowlight_003", "lowlight_004")
    assert sorted(os.listdir(tmp_path / "out")) == sorted({f"{s}_{k}.png" for s in stems for k in ("enhanced", "illumination", "comparison")})


@pytest.mark.parametrize(
    "args",
    [
        ["--spatial_shard", "--classical_mode", "clahe"],
        ["--mode", "train", "--use_amp", "--spatial_shard"],
        ["--spatial_shard", "--n_devices", "2"],
    ],
)
def test_unported_routes_raise(tmp_path, args, capsys):
    """Spatial sharding (ROADMAP Queue 1 item 9) is ported and raises on no
    mode: with a CLAHE mode on one CPU device it is ignored, in training it
    is ignored as the JAX trainer ignores it, and with --n_devices 2 the
    net's frame is split over two CPU shards (tests/test_torch_spatial_cli.py
    holds the runs to those without the flag)."""
    base = ["--mode", "enhance", "--input_path", str(PHOTO), "--output_dir", str(tmp_path), "--device", "cpu"]
    if "train" in args:
        args = args + ["--train_dir", str(PHOTO.parent), "--save_dir", str(tmp_path / "train"), "--image_size", "32",
                       "--batch_size", "8", "--num_epochs", "1", "--no-use_perceptual_loss"]
    cli.main(base + args)
    out = capsys.readouterr().out
    if "train" in args:
        assert (tmp_path / "train" / "latest" / "_METADATA").is_file()
    else:
        assert (tmp_path / f"{PHOTO.stem}_enhanced.png").exists()
        assert ("H split over 2 devices" in out) == ("--n_devices" in args)
