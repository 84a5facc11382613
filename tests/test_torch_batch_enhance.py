"""The port's directory enhance (bucketed batches) against its single-image
route and against the JAX package's ``enhance_batch_images``.

The directory holds two canvases (3 images of 96x64, 2 of 64x96) and runs at
batch 2, so each canvas ends on a ragged chunk.

- Batched against single, on the port: ``clahe`` and ``clahe_luma`` (at
  hist_subsample 1 and 2) byte-identical; the net routes within 1 level.
- The u8 route (K8 -> K2 -> K8, K2 -> K7; plain versions on the CPU) writes
  the bytes of the float route.
- Against the JAX package on the CPU, same weights, on the PNG bytes. The
  CLAHE modes: every image's bytes equal those of the JAX package's batch
  or those of its single-image route. The JAX package's two routes disagree
  with each other at exact rounding ties (its batch jits each chunk's whole
  pipeline, and XLA contracts the Lab and luma multiply-adds there unlike
  in the single-image route; a flipped u8 L or luma moves a tile histogram
  count and with it LUT entries: up to 7 levels on these images), and the
  port, batched or not, rounds one way throughout. The net within
  tests/test_torch_enhance.py:59-61.
- ``--n_devices`` above the visible cards raises.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.infer.enhance import enhance_batch_images as jax_batch
from retinex_tpu.infer.enhance import enhance_single_image as jax_single
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.infer import enhance as te
from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

KINDS = ("enhanced", "illumination", "comparison")
CLAHE_MODES = [("clahe", 1), ("clahe", 2), ("clahe_luma", 1), ("clahe_luma", 2)]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("in")
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (96, 64, 3), dtype=np.uint8)).save(d / f"tall_{i}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(d / f"wide_{i}.png")
    return d


@pytest.fixture(scope="module")
def port_apply():
    return cli.build_apply_fn(Config(mode="enhance", device="cpu"), torch.device("cpu"))


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int32)


def _stems(d) -> list[str]:
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d))


def test_buckets_and_outputs(image_dir, tmp_path):
    buckets = bucket_by_canvas([str(p) for p in sorted(image_dir.iterdir())], None)
    assert sorted((k[1], k[2], len(v)) for k, v in buckets.items()) == [(64, 96, 2), (96, 64, 3)]
    out = tmp_path / "out"
    timings = te.enhance_batch_images(None, str(image_dir), str(out), classical_mode="clahe", batch_size=2, device="cpu")
    assert len(timings) == 5
    assert sorted(os.listdir(out)) == sorted(f"{s}_{k}.png" for s in _stems(image_dir) for k in KINDS)


@pytest.mark.parametrize("mode,s", CLAHE_MODES)
def test_batched_clahe_matches_single(image_dir, tmp_path, mode, s):
    out_b, out_s = tmp_path / "batched", tmp_path / "single"
    te.enhance_batch_images(None, str(image_dir), str(out_b), classical_mode=mode, hist_subsample=s, batch_size=2, device="cpu")
    for stem in _stems(image_dir):
        te.enhance_single_image(
            None, str(image_dir / f"{stem}.png"), str(out_s), classical_mode=mode, hist_subsample=s, device="cpu"
        )
        for kind in ("enhanced", "comparison"):
            np.testing.assert_array_equal(_png(out_b / f"{stem}_{kind}.png"), _png(out_s / f"{stem}_{kind}.png"))


@pytest.mark.parametrize("knobs", [{}, {"enable_content_aware": True}, {"enable_multi_scale": True}])
def test_batched_net_matches_single(image_dir, tmp_path, port_apply, knobs):
    out_b, out_s = tmp_path / "batched", tmp_path / "single"
    te.enhance_batch_images(port_apply, str(image_dir), str(out_b), batch_size=2, device="cpu", **knobs)
    for stem in ("tall_2", "wide_1"):  # the ragged chunk of each canvas
        te.enhance_single_image(port_apply, str(image_dir / f"{stem}.png"), str(out_s), device="cpu", **knobs)
        for kind in ("enhanced", "illumination"):
            d = np.abs(_png(out_b / f"{stem}_{kind}.png") - _png(out_s / f"{stem}_{kind}.png"))
            assert d.max() <= 1, f"{stem}_{kind}: max diff {d.max()}"


@pytest.mark.parametrize("mode,s", CLAHE_MODES)
def test_u8_route_writes_the_float_routes_bytes(mode, s):
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8))
    u8_out, illu = te.make_batch_pipeline(None, mode, hist_subsample=s)(x)
    assert illu is None and u8_out.dtype == torch.uint8
    float_out = te._quant(te._classical_enhance(x.float() / 255.0, mode, hist_subsample=s))
    assert torch.equal(u8_out, float_out)


@pytest.mark.parametrize("mode,s", CLAHE_MODES)
def test_batch_clahe_matches_jax(image_dir, tmp_path, mode, s):
    out_j, out_js, out_t = tmp_path / "jax", tmp_path / "jax_single", tmp_path / "port"
    jax_batch(None, str(image_dir), str(out_j), classical_mode=mode, hist_subsample=s, batch_size=2)
    te.enhance_batch_images(None, str(image_dir), str(out_t), classical_mode=mode, hist_subsample=s, batch_size=2, device="cpu")
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for stem in _stems(image_dir):
        jax_single(None, str(image_dir / f"{stem}.png"), str(out_js), classical_mode=mode, hist_subsample=s)
        np.testing.assert_array_equal(_png(out_t / f"{stem}_illumination.png"), _png(out_j / f"{stem}_illumination.png"))
        got = _png(out_t / f"{stem}_enhanced.png")
        want = [_png(d / f"{stem}_enhanced.png") for d in (out_j, out_js)]
        assert any(np.array_equal(got, w) for w in want), (
            f"{stem}: max diff {np.abs(got - want[0]).max()} from the JAX batch, "
            f"{np.abs(got - want[1]).max()} from the JAX single-image route"
        )


def test_batch_net_matches_jax(image_dir, tmp_path):
    """One chunk (two 96x64 images), same weights: one compile of the JAX
    package's chunk pipeline."""
    one_canvas = tmp_path / "tall"
    one_canvas.mkdir()
    for i in range(2):
        (one_canvas / f"tall_{i}.png").write_bytes((image_dir / f"tall_{i}.png").read_bytes())
    # Seeded port weights, carried to Flax by the JAX package's own converter
    # (Flax's model.init alone takes ~20 s here).
    port = cli.init_untrained(MultiScaleUPRetinex(use_preact=False, use_aspp=False), seed=0).eval()
    variables = torch_state_dict_to_variables(port.state_dict(), False, False)
    model = JaxNet(use_preact=False, use_aspp=False)

    def port_apply(batch):
        with torch.inference_mode():
            return port(batch)

    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    jax_batch(lambda b: model.apply(variables, b, train=False), str(one_canvas), str(out_j), batch_size=2)
    te.enhance_batch_images(port_apply, str(one_canvas), str(out_t), batch_size=2, device="cpu")
    for stem in _stems(one_canvas):
        d = np.abs(_png(out_t / f"{stem}_enhanced.png") - _png(out_j / f"{stem}_enhanced.png"))
        assert d.max() <= 2 and (d > 0.5).mean() < 1e-3, f"{stem}: max {d.max()}, {(d > 0.5).mean()}"
        d = np.abs(_png(out_t / f"{stem}_illumination.png") - _png(out_j / f"{stem}_illumination.png"))
        assert d.max() <= 1, f"{stem} illumination: max {d.max()}"


def test_several_devices_raise(image_dir, tmp_path, monkeypatch):
    """More cards than are visible (one, here) raise; the JAX package's mesh
    takes what there is. (Directories over several devices run:
    tests/test_torch_parallel.py.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 CUDA devices asked for, 1 visible"):
        cli.main([
            "--mode", "enhance", "--input_path", str(image_dir), "--output_dir", str(tmp_path),
            "--classical_mode", "clahe", "--n_devices", "2", "--device", "cuda",
        ])
