"""The port's host path (``retinex_tpu_torch/data/native_loader.py``): the
JAX package's native loader's names and constants, with PIL decode on a
thread pool and a zlib PNG writer, no library built.

- ``decode_letterbox_batch`` and ``decode_letterbox_batch_canvas`` equal
  the serial PIL path (``dataset.decode_image`` + ``letterbox_np``) byte
  for byte, on the in-repo PNGs and on JPEGs made from them; the training
  loader's and the directory driver's batches go through them; a file that
  does not decode is gray-filled with the JAX native loader's warning, its
  batch that loader's byte for byte (a JPEG cut short decoded as libjpeg
  decodes it); a canvas that an image does not letterbox to raises.
- ``encode_png`` files decode (PIL) to the array written, RGB and gray, for
  each filter and strategy; the default IDAT has filter type 1 (SUB) on
  every row; its constants are the JAX package's.
- One photo's three PNGs (enhance and predict) hold today's pixels: the
  arrays ``save_image`` and ``create_comparison`` quantise.
"""

import ast
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.data import native_loader as jax_loader
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.data import native_loader as nl
from retinex_tpu_torch.data.dataset import LowLightDataset, TrainLoader, decode_image
from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas, decode_bucket
from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
from retinex_tpu_torch.infer.predict import predict_single_image
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox
from retinex_tpu_torch.utils.viz import create_comparison

REPO = Path(__file__).resolve().parents[1]
PHOTOS = sorted((REPO / "data" / "convergence").glob("*.png"))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Four in-repo PNGs, cropped to three shapes, and JPEGs of them."""
    d = tmp_path_factory.mktemp("img")
    paths = {"png": [], "jpeg": []}
    for i, (p, (h, w)) in enumerate(zip(PHOTOS, [(640, 640), (480, 640), (640, 360), (301, 517)])):
        img = np.asarray(Image.open(p).convert("RGB"))[:h, :w]
        for kind, ext in (("png", "png"), ("jpeg", "jpg")):
            path = d / f"{i}.{ext}"
            Image.fromarray(np.ascontiguousarray(img)).save(path, **({"quality": 90} if ext == "jpg" else {}))
            paths[kind].append(str(path))
    return paths


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("size,auto_pad,scaleup", [(256, False, True), (128, False, False), (320, True, True)])
def test_decode_letterbox_batch_equals_the_serial_path(images, kind, size, auto_pad, scaleup):
    paths = images[kind]
    serial = []
    for p in paths:
        rgb = decode_image(p)
        serial.append(letterbox_np(rgb, plan_letterbox(rgb.shape[0], rgb.shape[1], size, auto=auto_pad, scaleup=scaleup)))
    if auto_pad and len({s.shape for s in serial}) > 1:
        with pytest.raises(ValueError, match="letterboxes to"):
            nl.decode_letterbox_batch(paths, size, auto_pad, scaleup, num_threads=3)
        return
    got = nl.decode_letterbox_batch(paths, size, auto_pad, scaleup, num_threads=3)
    np.testing.assert_array_equal(got, np.stack(serial))


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("max_size", [None, 256])
def test_decode_canvas_equals_the_serial_path(images, kind, max_size):
    for (target, out_h, out_w), paths in bucket_by_canvas(images[kind], max_size).items():
        serial = []
        for p in paths:
            rgb = decode_image(p)
            serial.append(letterbox_np(rgb, plan_letterbox(rgb.shape[0], rgb.shape[1], target, auto=True, scaleup=False)))
        got = nl.decode_letterbox_batch_canvas(paths, target, out_h, out_w, num_threads=4)
        np.testing.assert_array_equal(got, np.stack(serial))
        np.testing.assert_array_equal(decode_bucket(paths, target, out_h, out_w, num_workers=2), got)


@pytest.fixture(scope="module")
def bad_batch(tmp_path_factory):
    """Two good 128x128 images (PNG, JPEG), a JPEG cut in half and a file
    that is no image. The crops are the canvas's size, so the letterbox
    copies them: the comparison with the native loader is of the decode
    and the gray fill (its bilinear resize's one-level rounding divergence
    is a fault of its own, ROADMAP Queue 3)."""
    d = tmp_path_factory.mktemp("bad")
    good = []
    for i, ext in enumerate(("png", "jpg")):
        img = np.ascontiguousarray(np.asarray(Image.open(PHOTOS[i]).convert("RGB"))[100:228, 200:328])
        good.append(d / f"good{i}.{ext}")
        Image.fromarray(img).save(good[-1], **({"quality": 90} if ext == "jpg" else {}))
    full = good[1].read_bytes()
    (d / "cut.jpg").write_bytes(full[: len(full) // 2])
    (d / "bad.png").write_bytes(b"not an image")
    return [str(good[0]), str(d / "cut.jpg"), str(d / "bad.png"), str(good[1])]


def _decoded_with_warning(fn, *args) -> tuple[np.ndarray, list[str]]:
    with pytest.warns(UserWarning) as record:
        out = fn(*args)
    return out, [str(w.message) for w in record if "images failed to decode" in str(w.message)]


@pytest.mark.parametrize("case", ["canvas_raises", "bad_file_gray_fills"])
def test_decode_raises_on_a_bad_file_or_canvas(images, bad_batch, case):
    if case == "canvas_raises":  # a plan that does not fit the canvas raises, as before
        with pytest.raises(ValueError, match="letterboxes to"):
            nl.decode_letterbox_batch_canvas(images["png"][:1], 640, 320, 320)
        return
    # A file that does not decode: its row gray 114 and one warning, the JAX
    # native loader's batch byte for byte; the cut JPEG decodes as libjpeg
    # decodes it (not gray), the non-image is gray.
    assert jax_loader.native_available()
    for port_fn, jax_fn, args in (
        (nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, (bad_batch, 128)),
        (nl.decode_letterbox_batch_canvas, jax_loader.decode_letterbox_batch_canvas, (bad_batch, 128, 128, 128)),
    ):
        got, got_warn = _decoded_with_warning(port_fn, *args)
        want, want_warn = _decoded_with_warning(jax_fn, *args)
        assert got_warn == want_warn == ["native loader: 1/4 images failed to decode (gray-filled)"]
        np.testing.assert_array_equal(got, want)
        assert (got[2] == nl.GRAY_FILL).all() and not (got[1] == nl.GRAY_FILL).all()
    bucket, bucket_warn = _decoded_with_warning(decode_bucket, bad_batch, 128, 128, 128, 2)
    np.testing.assert_array_equal(bucket, got)
    assert bucket_warn == got_warn


def test_training_loader_batches_go_through_the_host_path(monkeypatch):
    ds = LowLightDataset(str(PHOTOS[0].parent), image_size=64)
    calls = []
    real = nl.decode_letterbox_batch
    monkeypatch.setattr(nl, "decode_letterbox_batch", lambda *a, **k: calls.append(a) or real(*a, **k))
    loader = TrainLoader(ds, batch_size=5, shuffle=True, num_workers=3, seed=7)
    order = TrainLoader(ds, batch_size=5, shuffle=True, seed=7).epoch_order()
    batches = list(loader)
    assert len(calls) == len(batches) == 5
    np.testing.assert_array_equal(batches[0], np.stack([ds[i] for i in order[:5]]))


def _content(kind: str, shape: tuple[int, ...]) -> np.ndarray:
    rng = np.random.default_rng(sum(shape))
    if kind == "walk":  # smooth rows, wrapping: SUB's differences cross 0 and 255
        return np.clip(rng.normal(120, 40, shape).cumsum(axis=1) % 256, 0, 255).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "flat":
        return np.full(shape, 255, np.uint8)
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256  # "ramp"
    return np.ascontiguousarray(np.broadcast_to(ramp.reshape(shape[:2] + (1,) * (len(shape) - 2)), shape), np.uint8)


@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 96, 3), (21, 17)])
@pytest.mark.parametrize("kind", ["walk", "noise", "flat", "ramp", "one_column"])
def test_encode_png_decodes_to_the_array(tmp_path, shape, kind):
    if kind == "one_column":
        shape = (shape[0], 1) + shape[2:]
    arr = _content("walk" if kind == "one_column" else kind, shape)
    path = tmp_path / "a.png"
    assert nl.encode_png(arr, str(path)) is True
    with Image.open(path) as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), arr)


@pytest.mark.parametrize("filters,strategy", [(0, 0), (2, 0), (1, 1), (1, 2)])
def test_encode_png_takes_only_the_sub_filter_and_default_strategy(tmp_path, filters, strategy):
    path = tmp_path / "a.png"
    with pytest.raises(ValueError, match="SUB filter"):
        nl.encode_png(np.zeros((4, 4, 3), np.uint8), str(path), filters=filters, strategy=strategy)
    assert not path.exists()


def _idat_rows(path: Path, h: int, row_bytes: int) -> np.ndarray:
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, i = [], 8
    while i < len(data):
        n = int.from_bytes(data[i : i + 4], "big")
        chunks.append((data[i + 4 : i + 8], data[i + 8 : i + 8 + n]))
        i += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    return np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, 1 + row_bytes)


def test_encode_png_defaults_are_level_1_sub(tmp_path):
    assert (nl.PNG_LEVEL, nl.PNG_FILTER_SUB, nl.PNG_STRATEGY_DEFLATE) == (
        jax_loader.PNG_LEVEL, jax_loader.PNG_FILTER_SUB, jax_loader.PNG_STRATEGY_DEFLATE)
    arr = np.asarray(Image.open(PHOTOS[1]).convert("RGB"))
    path = tmp_path / "photo.png"
    nl.encode_png(arr, str(path))
    rows = _idat_rows(path, arr.shape[0], 3 * arr.shape[1])
    assert (rows[:, 0] == 1).all()
    raw = arr.reshape(arr.shape[0], -1)
    np.testing.assert_array_equal(rows[:, 4:], raw[:, 3:] - raw[:, :-3])
    assert nl.native_available() is True
    with pytest.raises(ValueError):
        nl.encode_png(arr.astype(np.float32), str(path))


def test_module_builds_and_reads_nothing_native():
    src = Path(nl.__file__).read_text()
    imported = {n.names[0].name.split(".")[0] for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Import)}
    imported |= {n.module.split(".")[0] for n in ast.walk(ast.parse(src)) if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "retinex_tpu", "ctypes", "subprocess"}, imported
    assert "native/" not in src.replace("``native/``", "")


def _pngs(out: Path, stem: str) -> dict[str, np.ndarray]:
    return {k: np.asarray(Image.open(out / f"{stem}_{k}.png")) for k in ("enhanced", "illumination", "comparison")}


def test_single_photo_pngs_hold_todays_pixels(tmp_path):
    """Enhance (the net and clahe_luma) and predict: each file decodes to the
    array save_image quantises (clip * 255 truncated, one channel
    replicated) and create_comparison builds."""
    photo = str(PHOTOS[2])
    model = init_untrained(MultiScaleUPRetinex(False, False), 0).eval()

    def apply_fn(x):
        with torch.inference_mode():
            return model(x)

    q = lambda v: (np.clip(v.numpy(), 0.0, 1.0) * 255).astype(np.uint8)  # noqa: E731
    img, _ = load_image(photo, 256)
    for mode in (None, "clahe_luma"):
        out = tmp_path / f"enh_{mode}"
        enh, illu, _ = enhance_single_image(apply_fn, photo, str(out), max_size=256, classical_mode=mode, device="cpu")
        got = _pngs(out, PHOTOS[2].stem)
        np.testing.assert_array_equal(got["enhanced"], q(enh))
        np.testing.assert_array_equal(got["illumination"], np.repeat(q(illu), 3, axis=-1))
        np.testing.assert_array_equal(got["comparison"], create_comparison(img, enh))
    out = tmp_path / "pred"
    enh, illu, _ = predict_single_image(apply_fn, photo, str(out), max_size=256, device="cpu")
    got = _pngs(out, PHOTOS[2].stem)
    np.testing.assert_array_equal(got["enhanced"], q(enh))
    np.testing.assert_array_equal(got["illumination"], np.repeat(q(illu), 3, axis=-1))
    np.testing.assert_array_equal(got["comparison"], create_comparison(img, enh, illu))
