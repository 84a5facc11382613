"""The port's data mesh (``retinex_tpu_torch/parallel/mesh.py``) and its
batch-sharded directory routes (``infer/batch_driver.shard_batch_fn``).

- ``pad_to_multiple`` equals the JAX package's on every batch size and
  multiple of the set.
- ``create_mesh`` raises where more cards are asked for than are visible
  (the JAX function truncates: a chosen divergence), and gives ``n``
  logical shards of the CPU.
- Over a 4-shard CPU mesh, directory enhance (the default route and
  ``clahe``), predict and evaluate write the bytes of the one-device run.
  The directory has two canvases and runs at batch 3, so every chunk is
  padded to the mesh (3 -> 4, 2 -> 4) and its padding dropped. PyTorch's
  CPU reductions split a reduction over threads by the tensor's size, so a
  per-image mean can part in its last bit between a batch of 3 and one of
  1 with several threads; the file runs on one thread, where they do not.
- The same routes over the JAX package's 4-device mesh (its
  ``maybe_mesh(4)`` of the 8 virtual CPU devices), on one canvas, same
  weights, within the bounds of the JAX-holding tests of each route
  (tests/test_torch_batch_enhance.py, test_torch_predict.py,
  test_torch_evaluate.py).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.infer.batch_driver import maybe_mesh as jax_maybe_mesh
from retinex_tpu.infer.enhance import enhance_batch_images as jax_enhance
from retinex_tpu.infer.evaluate import evaluate_directory as jax_evaluate
from retinex_tpu.infer.predict import predict_batch as jax_predict
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu.parallel.mesh import pad_to_multiple as jax_pad
from retinex_tpu_torch import cli
from retinex_tpu_torch.infer.enhance import enhance_batch_images
from retinex_tpu_torch.infer.evaluate import evaluate_directory
from retinex_tpu_torch.infer.predict import predict_batch
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.parallel import mesh as tm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (96, 64, 3), dtype=np.uint8)).save(d / f"tall_{i}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(d / f"wide_{i}.png")
    return d


@pytest.fixture(scope="module")
def net():
    """Seeded weights (the CLI's untrained draw at seed 3), as a module and
    as Flax variables."""
    port = cli.init_untrained(MultiScaleUPRetinex(use_preact=False, use_aspp=False), seed=3).eval()
    return port, torch_state_dict_to_variables(port.state_dict(), False, False)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("n,multiple", [(1, 4), (3, 4), (4, 4), (5, 4), (5, 8), (7, 2), (9, 3), (2, 1)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = np.random.default_rng(n).integers(0, 256, (n, 4, 5, 3), dtype=np.uint8)
    got, got_n = tm.pad_to_multiple(batch, multiple)
    want, want_n = jax_pad(batch, multiple)
    assert got_n == want_n == n and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got, want)


def test_create_mesh(monkeypatch):
    mesh = tm.create_mesh(4, "cpu")
    assert mesh.size == 4 and set(mesh.devices) == {torch.device("cpu")}
    assert tm.create_mesh(None, "cpu").size == 1
    with pytest.raises(ValueError, match="at least one"):
        tm.create_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tm.create_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="3 CUDA devices asked for, 2 visible"):
        tm.create_mesh(3)


ROUTES = ("net", "clahe", "predict", "evaluate")


def _run(route, port, src, out, mesh):
    if route in ("net", "clahe"):
        def apply(batch):
            with torch.inference_mode():
                return port(batch)

        apply_fn = None if route == "clahe" else (apply if mesh is None else tm.replicate(lambda _d: apply, mesh))
        enhance_batch_images(apply_fn, str(src), str(out), classical_mode=route if route == "clahe" else None,
                             batch_size=3, num_workers=2, device="cpu", mesh=mesh)
    elif route == "predict":
        def apply(batch):
            with torch.inference_mode():
                return port(batch)

        predict_batch(apply, str(src), str(out), batch_size=3, num_workers=2, device="cpu", mesh=mesh)
    else:
        evaluate_directory(str(src), output_csv=str(out / "metrics.csv"), batch_size=3, device="cpu", mesh=mesh)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_route_is_byte_identical_to_one_device(route, image_dir, net, tmp_path):
    port, _ = net
    one, four = tmp_path / "one", tmp_path / "four"
    for out, mesh in ((one, None), (four, tm.create_mesh(4, "cpu"))):
        out.mkdir()
        _run(route, port, image_dir, out, mesh)
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(four)) and len(names) == (1 if route == "evaluate" else 15)
    for name in names:
        assert (one / name).read_bytes() == (four / name).read_bytes(), name


def test_sharded_routes_hold_to_jax(image_dir, net, tmp_path):
    """One canvas (the three 96x64 images; a chunk of 3 padded to 4 on both
    meshes), each route through both packages' meshes."""
    port, variables = net
    src = tmp_path / "tall"
    src.mkdir()
    for i in range(3):
        (src / f"tall_{i}.png").write_bytes((image_dir / f"tall_{i}.png").read_bytes())
    model = JaxNet(use_preact=False, use_aspp=False)
    jax_mesh = jax_maybe_mesh(4)
    assert jax_mesh.devices.size == 4
    mesh = tm.create_mesh(4, "cpu")

    def jax_apply(b):
        return model.apply(variables, b, train=False)

    stems = [f"tall_{i}" for i in range(3)]
    for route in ("net", "clahe", "predict"):
        jd, td = tmp_path / f"jax_{route}", tmp_path / f"port_{route}"
        td.mkdir()
        _run(route, port, src, td, mesh)
        if route == "predict":
            jax_predict(jax_apply, str(src), str(jd), batch_size=3, mesh=jax_mesh)
        else:
            jax_enhance(None if route == "clahe" else jax_apply, str(src), str(jd), batch_size=3, mesh=jax_mesh,
                        classical_mode="clahe" if route == "clahe" else None)
        for stem in stems:
            for kind in ("enhanced", "illumination"):
                d = np.abs(_png(td / f"{stem}_{kind}.png") - _png(jd / f"{stem}_{kind}.png"))
                if route == "clahe":
                    # The JAX package's jitted chunk pipeline contracts the Lab
                    # multiply-adds, which moves a u8 L at an exact tie and with
                    # it a tile's LUT entries (tests/test_torch_batch_enhance.py:
                    # up to 7 levels); the port rounds one way throughout.
                    print(f"clahe {stem}_{kind}: max {d.max()}, {(d > 0).mean():.2e} of the bytes differ")
                    assert d.max() <= 7 and (d > 0).mean() < 1e-2, f"{route} {stem}_{kind}: max {d.max()}"
                elif route == "predict":
                    assert d.max() <= 1 and (d > 0).mean() < 1e-3, f"{route} {stem}_{kind}: max {d.max()}"
                elif kind == "enhanced":
                    assert d.max() <= 2 and (d > 0.5).mean() < 1e-3, f"{route} {stem}: max {d.max()}"
                else:
                    assert d.max() <= 1, f"{route} {stem}_{kind}: max {d.max()}"

    want = jax_evaluate(str(src), output_csv=str(tmp_path / "jax.csv"), batch_size=3, mesh=jax_mesh)
    got = evaluate_directory(str(src), output_csv=str(tmp_path / "port.csv"), batch_size=3, device="cpu", mesh=mesh)
    assert [r["image"] for r in got] == [r["image"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k != "image":
                rtol = 1e-4 if k == "mean_brightness" else 1e-5
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"{g['image']} {k}")
