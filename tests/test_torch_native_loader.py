"""The port's host path (``retinex_tpu_torch/data/native_loader.py``): the
JAX package's native loader's names and constants, with PIL decode and a
numpy letterbox on a thread pool and a zlib PNG writer, no library built.
Every comparison is byte-exact.

- ``decode_letterbox_batch`` and ``decode_letterbox_batch_canvas`` give the
  JAX package's native loader's bytes (``retinex_tpu.data.native_loader``,
  its C++ library): on the in-repo PNGs and on JPEGs made from them, resized
  and not, with and without ``auto_pad`` and ``scaleup``; on every format
  of ``tests/fixtures/host_formats`` (PNG colour types, bit depths, tRNS
  and interlace; JPEG subsamplings, progressive, gray and CMYK; BMP, TIFF,
  WebP and GIF, which it gray-fills), whose bytes' SHA-256 are in
  ``expected.json``; at the resize's rounding ties and the geometry's; with
  the same gray fills and warnings. The training loader's and the directory
  driver's batches go through them and equal the JAX package's; a canvas
  that an image does not letterbox to raises.
- ``list_image_files`` takes the JAX signature and defaults.
- ``encode_png`` files decode (PIL) to the array written, RGB and gray, for
  each filter and strategy; the default IDAT has filter type 1 (SUB) on
  every row; its constants are the JAX package's.
- One photo's three PNGs (enhance and predict) hold today's pixels: the
  arrays ``save_image`` and ``create_comparison`` quantise.
"""

import ast
import hashlib
import json
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.data import dataset as jax_dataset
from retinex_tpu.data import native_loader as jax_loader
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.data import dataset as port_dataset
from retinex_tpu_torch.data import native_loader as nl
from retinex_tpu_torch.data.dataset import LowLightDataset, TrainLoader
from retinex_tpu_torch.infer.batch_driver import bucket_by_canvas, decode_bucket
from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
from retinex_tpu_torch.infer.predict import predict_single_image
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox
from retinex_tpu_torch.utils.viz import create_comparison

REPO = Path(__file__).resolve().parents[1]
PHOTOS = sorted((REPO / "data" / "convergence").glob("*.png"))
FORMATS = REPO / "tests" / "fixtures" / "host_formats"
FAILED = "images failed to decode"


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX native loader's library. Each test process builds it on first
    use (``make -C native``); where another process's build is still
    writing it, its load fails once, so wait for the finished file."""
    for _ in range(120):
        if jax_loader.native_available():
            return
        jax_loader._load_failed = False
        time.sleep(1)
    pytest.fail("the JAX native loader's library does not load")


def _decoded(fn, *args, **kw) -> tuple[np.ndarray, list[str]]:
    """fn's batch and the loader's warnings."""
    import warnings

    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(w.message) for w in record if FAILED in str(w.message)]


def _same_as_jax(port_fn, jax_fn, *args, **kw) -> tuple[np.ndarray, list[str]]:
    """The port's batch and warnings, asserted equal to the JAX native
    loader's on the same arguments."""
    assert jax_loader.native_available()
    got, got_warn = _decoded(port_fn, *args, **kw)
    want, want_warn = _decoded(jax_fn, *args, **kw)
    assert got_warn == want_warn
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got, got_warn


def _hw(path: str) -> tuple[int, int]:
    with Image.open(path) as im:
        return im.height, im.width


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
def test_decode_letterbox_batch_equals_the_jax_native_loader(images, kind, size, auto_pad, scaleup):
    paths = images[kind]
    plans = [plan_letterbox(h, w, size, auto=auto_pad, scaleup=scaleup) for h, w in map(_hw, paths)]
    if len({(p.out_h, p.out_w) for p in plans}) > 1:  # the batch's canvas is not every image's: the port raises
        with pytest.raises(ValueError, match="letterboxes to"):
            nl.decode_letterbox_batch(paths, size, auto_pad, scaleup, num_threads=3)
        return
    got, warned = _same_as_jax(nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch,
                               paths, size, auto_pad, scaleup, num_threads=3)
    assert not warned and got.shape == (len(paths), size, size, 3)


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("max_size", [None, 256])
def test_decode_canvas_equals_the_jax_native_loader(images, kind, max_size):
    for (target, out_h, out_w), paths in bucket_by_canvas(images[kind], max_size).items():
        got, _ = _same_as_jax(nl.decode_letterbox_batch_canvas, jax_loader.decode_letterbox_batch_canvas,
                              paths, target, out_h, out_w, num_threads=4)
        np.testing.assert_array_equal(decode_bucket(paths, target, out_h, out_w, num_workers=2), got)


# The format fixtures: one 37x53 crop of a photo in each format, decoded at
# image_size 53 (letterboxed, not resized) and 40 (resized to 28x40).
FORMAT_SIZES = {"unresized": 53, "resized": 40}


def _png_file(samples: np.ndarray, bit_depth: int, color_type: int, plte=None, trns=None, adam7=False) -> bytes:
    """A PNG of `samples` [H, W, C] as written (no filter), with the given
    IHDR depth and colour type, PLTE and tRNS bytes, Adam7 interlaced or not:
    the cases libpng normalises, which PIL's writer does not all make."""

    def rows(sub: np.ndarray) -> bytes:
        out = []
        for row in sub.reshape(sub.shape[0], -1):
            if bit_depth == 16:
                raw = row.astype(">u2").tobytes()
            elif bit_depth == 8:
                raw = row.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bit_depth :]
                raw = np.packbits(bits.reshape(-1)).tobytes()
            out.append(b"\x00" + raw)
        return b"".join(out)

    if adam7:
        passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
        data = b"".join(rows(samples[y::dy, x::dx]) for x, y, dx, dy in passes if samples[y::dy, x::dx].size)
    else:
        data = rows(samples)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h, w = samples.shape[:2]
    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, int(adam7)))]
    parts += [chunk(b"PLTE", plte)] if plte is not None else []
    parts += [chunk(b"tRNS", trns)] if trns is not None else []
    return b"".join(parts + [chunk(b"IDAT", zlib.compress(data, 9)), chunk(b"IEND", b"")])


def host_format_files() -> dict[str, tuple[str, bytes]]:
    """Each format case: (file name, bytes), from a 37x53 crop of
    data/convergence/lowlight_003.png and a seeded low byte for 16 bits."""
    import io

    src = Image.open(PHOTOS[3]).convert("RGB").crop((300, 260, 353, 297))
    rgb = np.asarray(src)
    gray = np.asarray(src.convert("L"))[:, :, None]
    low = np.random.default_rng(25).integers(0, 256, rgb.shape, dtype=np.uint16)
    rgb16, gray16 = (rgb.astype(np.uint16) << 8) | low, (gray.astype(np.uint16) << 8) | low[:, :, :1]
    alpha = np.random.default_rng(26).integers(0, 256, gray.shape, dtype=np.uint16)
    pal = src.quantize(colors=256)
    pal16 = src.quantize(colors=16)
    idx, idx16 = np.asarray(pal)[:, :, None], np.asarray(pal16)[:, :, None]
    plte = bytes(pal.getpalette()[: 3 * 256])
    plte16 = bytes(pal16.getpalette()[: 3 * 16])
    g0 = int(gray[0, 0, 0])
    files = {
        "png_rgb8": _png_file(rgb, 8, 2),
        "png_rgb8_trns": _png_file(rgb, 8, 2, trns=struct.pack(">HHH", *rgb[0, 0])),
        "png_gray8": _png_file(gray, 8, 0),
        "png_gray8_trns": _png_file(gray, 8, 0, trns=struct.pack(">H", g0)),
        "png_gray1": _png_file((gray > 40).astype(np.uint8), 1, 0),
        "png_gray2": _png_file(gray >> 6, 2, 0),
        "png_gray4": _png_file(gray >> 4, 4, 0),
        "png_gray4_adam7": _png_file(gray >> 4, 4, 0, adam7=True),
        "png_gray16": _png_file(gray16, 16, 0),
        "png_gray16_trns": _png_file(gray16, 16, 0, trns=struct.pack(">H", int(gray16[0, 0, 0]))),
        "png_gray16_adam7": _png_file(gray16, 16, 0, adam7=True),
        "png_rgb16": _png_file(rgb16, 16, 2),
        "png_rgba16": _png_file(np.concatenate([rgb16, alpha * 257], axis=2), 16, 6),
        "png_gray_alpha8": _png_file(np.concatenate([gray, alpha], axis=2), 8, 4),
        "png_gray_alpha16": _png_file(np.concatenate([gray16, alpha * 257], axis=2), 16, 4),
        "png_rgba8": _png_file(np.concatenate([rgb, alpha], axis=2), 8, 6),
        "png_palette8": _png_file(idx, 8, 3, plte=plte),
        "png_palette8_trns": _png_file(idx, 8, 3, plte=plte, trns=bytes(range(0, 256, 2))),
        "png_palette4": _png_file(idx16, 4, 3, plte=plte16),
        "png_rgb8_adam7": _png_file(rgb, 8, 2, adam7=True),
    }
    names = {k: f"{k}.png" for k in files}

    def pil(img: Image.Image, fmt: str, **kw) -> bytes:
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    for case, img, fmt, ext, kw in [
        ("jpeg_420", src, "JPEG", "jpg", {"quality": 90, "subsampling": 2}),
        ("jpeg_444", src, "JPEG", "jpg", {"quality": 90, "subsampling": 0}),
        ("jpeg_progressive", src, "JPEG", "jpg", {"quality": 85, "progressive": True}),
        ("jpeg_gray", src.convert("L"), "JPEG", "jpg", {"quality": 90}),
        ("jpeg_cmyk", src.convert("CMYK"), "JPEG", "jpg", {"quality": 90}),
        ("bmp", src, "BMP", "bmp", {}),
        ("tiff", src, "TIFF", "tif", {}),
        ("webp", src, "WEBP", "webp", {"lossless": True}),
        ("gif", src, "GIF", "gif", {}),
        ("bmp_named_png", src, "BMP", "png", {}),
    ]:
        files[case], names[case] = pil(img, fmt, **kw), f"{case}.{ext}"
    files["png_named_jpg"], names["png_named_jpg"] = files["png_rgb8"], "png_named_jpg.jpg"
    return {k: (names[k], files[k]) for k in files}


def write_host_format_fixtures(out_dir: Path = FORMATS) -> None:
    """Write the format fixtures and ``expected.json``: for each case and
    size, whether the JAX native loader decodes the file and the SHA-256 of
    its [1, size, size, 3] batch. Run by hand to rewrite the committed copy
    (the card's machine has no JAX to make the digests)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cases = {}
    for case, (name, data) in host_format_files().items():
        (out_dir / name).write_bytes(data)
        entry = {"file": name}
        for label, size in FORMAT_SIZES.items():
            batch, warned = _decoded(jax_loader.decode_letterbox_batch, [str(out_dir / name)], size, num_threads=1)
            entry["decodes"] = not warned
            entry[label] = hashlib.sha256(batch.tobytes()).hexdigest()
        cases[case] = entry
    body = {"sizes": FORMAT_SIZES, "cases": cases}
    (out_dir / "expected.json").write_text(json.dumps(body, indent=1, sort_keys=True) + "\n")


FORMAT_EXPECTED = json.loads((FORMATS / "expected.json").read_text())
FAILS = {"jpeg_cmyk", "bmp", "tiff", "webp", "gif", "bmp_named_png"}  # gray-filled by the JAX native loader


def test_format_fixtures_are_the_generators():
    """The committed files are host_format_files()'s, under 300 KB."""
    files = host_format_files()
    assert set(files) == set(FORMAT_EXPECTED["cases"])
    for case, (name, data) in files.items():
        assert FORMAT_EXPECTED["cases"][case]["file"] == name
        assert (FORMATS / name).read_bytes() == data, case
    assert sum(p.stat().st_size for p in FORMATS.iterdir()) < 300_000


@pytest.mark.parametrize("size", sorted(FORMAT_SIZES))
@pytest.mark.parametrize("case", sorted(FORMAT_EXPECTED["cases"]))
def test_formats_give_the_jax_native_loaders_bytes(case, size):
    """Each format, as one batch and as a canvas, equals the JAX native
    loader's batch with its warning, and its digest is expected.json's."""
    want = FORMAT_EXPECTED["cases"][case]
    path = [str(FORMATS / want["file"])]
    n = FORMAT_SIZES[size]
    got, warned = _same_as_jax(nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, path, n, num_threads=1)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want[size]
    assert (case in FAILS) == (not want["decodes"]) == bool(warned)
    if warned:
        assert warned == ["native loader: 1/1 images failed to decode (gray-filled)"] and (got == nl.GRAY_FILL).all()
    plan = plan_letterbox(37, 53, n, auto=True, scaleup=False)
    _same_as_jax(nl.decode_letterbox_batch_canvas, jax_loader.decode_letterbox_batch_canvas,
                 path, n, plan.out_h, plan.out_w, num_threads=1)


def test_decode_applies_no_decompression_bomb_check(monkeypatch):
    """The C++ loader decodes any size; PIL's process-wide limit is neither
    applied nor changed."""
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 100)
    for case in ("png_rgb8", "jpeg_420"):
        path = [str(FORMATS / FORMAT_EXPECTED["cases"][case]["file"])]
        with pytest.raises(Image.DecompressionBombError):
            Image.open(path[0])
        got, warned = _decoded(nl.decode_letterbox_batch, path, 53, num_threads=1)
        assert not warned and hashlib.sha256(got.tobytes()).hexdigest() == FORMAT_EXPECTED["cases"][case]["unresized"]
    assert Image.MAX_IMAGE_PIXELS == 100


def _write_rgb(path: Path, img: np.ndarray) -> str:
    Image.fromarray(np.ascontiguousarray(img)).save(path)
    return str(path)


@pytest.mark.parametrize("case", ["half", "below_half"])
def test_resize_rounds_ties_as_the_native_loader(tmp_path, case):
    """Exact ties: [[0, 2], [0, 2]] upscaled to 4x4 interpolates to .5 and
    1.5 (rounded away from zero: 1 and 2, where letterbox_np's halves to
    even give 0 and 2); [[2, 1], [1, 0]] at 12x12 lands on 0.49999997f at
    (6, 8), which lround takes to 0 and floor(v + 0.5) in f32 to 1 (and
    letterbox_np, whose f64 value lies above .5, to 1)."""
    if case == "half":
        img, size, at, want, f64 = np.array([[0, 2], [0, 2]]), 4, (0, 1), 1, 0
    else:
        img, size, at, want, f64 = np.array([[2, 1], [1, 0]]), 12, (6, 8), 0, 1
    img = np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)
    out = nl.resize_bilinear_u8(img, size, size)
    assert (out[at] == want).all()
    assert (letterbox_np(img, plan_letterbox(2, 2, size))[at] == f64).all()
    if case == "below_half":
        y0, y1, fy0, fy1 = nl._axis(2, size)
        x0, x1, fx0, fx1 = nl._axis(2, size)
        (y, x), f = at, img[:, :, 0]
        v = (f[y0[y], x0[x]] * fx0[x] + f[y0[y], x1[x]] * fx1[x]) * fy0[y] + (
            f[y1[y], x0[x]] * fx0[x] + f[y1[y], x1[x]] * fx1[x]) * fy1[y]
        assert v == np.nextafter(np.float32(0.5), np.float32(0)) and np.floor(v + np.float32(0.5)) == 1
    path = _write_rgb(tmp_path / "tie.png", img)
    got, _ = _same_as_jax(nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, [path], size, num_threads=1)
    np.testing.assert_array_equal(got[0], out)


@pytest.mark.parametrize("route", ["training", "canvas"])
def test_letterbox_geometry_rounds_as_the_native_loader(tmp_path, route):
    """Where the unpadded size lands on .5 the C++ geometry rounds it away
    from zero and plan_letterbox to even. Training: a 16x5 image at 8 is
    resized to 8x3 at column 2 (the plan: 8x2 at column 3). A directory
    canvas: a 65x128 image at max_size 64 plans to a 32x64 canvas, where
    the C++ geometry (33 rows, top 15) does not fit, so the JAX native
    loader gray-fills it and counts it; the port does the same."""
    rng = np.random.default_rng(9)
    if route == "training":
        path = _write_rgb(tmp_path / "thin.png", rng.integers(0, 256, (16, 5, 3), dtype=np.uint8))
        got, warned = _same_as_jax(nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, [path], 8,
                                   num_threads=1)
        assert not warned and (got[0, :, 2:5] != nl.GRAY_FILL).any() and (got[0, :, :2] == nl.GRAY_FILL).all()
        return
    paths = [_write_rgb(tmp_path / f"{h}.png", rng.integers(0, 256, (h, 128, 3), dtype=np.uint8)) for h in (64, 65)]
    (target, out_h, out_w), = bucket_by_canvas(paths, 64)
    assert (out_h, out_w) == (32, 64)
    got, warned = _same_as_jax(nl.decode_letterbox_batch_canvas, jax_loader.decode_letterbox_batch_canvas,
                               paths, target, out_h, out_w, num_threads=2)
    assert warned == ["native loader: 1/2 images failed to decode (gray-filled)"] and (got[1] == nl.GRAY_FILL).all()
    _, bucket_warned = _decoded(decode_bucket, paths, target, out_h, out_w, 2)
    assert bucket_warned == warned


def test_training_loader_equals_the_jax_prefetch_iterator():
    """--image_size 256 on the 24 in-repo photos (640x640, so each resizes):
    the port's TrainLoader batches are the JAX _PrefetchIterator's, which
    decodes through the native loader."""
    kw = dict(batch_size=8, image_size=256, num_workers=2, shuffle=True, seed=3)
    jl = jax_dataset.get_train_loader(str(PHOTOS[0].parent), **kw)
    tl = port_dataset.get_train_loader(str(PHOTOS[0].parent), **kw)
    it = iter(jl)
    assert it.use_native
    want = list(it)
    got = list(iter(tl))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_list_image_files_takes_the_jax_signature(tmp_path):
    """Nested, mixed extensions: both functions list the same files, by
    default (recursive, training extensions), positionally and by keyword."""
    for name in ("a.png", "b.JPG", "c.bmp", "d.tif", "e.tiff", "f.txt", "g.jpeg",
                 "sub/h.png", "sub/i.TIF", "sub/deeper/j.jpg", "sub/k.gif"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    d = str(tmp_path)
    port, jax = port_dataset.list_image_files, jax_dataset.list_image_files
    assert port(d) == jax(d) == sorted(str(tmp_path / n) for n in (
        "a.png", "b.JPG", "c.bmp", "g.jpeg", "sub/h.png", "sub/deeper/j.jpg"))
    assert port(d, False) == jax(d, False)
    assert port(d, True, port_dataset.VALID_EXTENSIONS_ENHANCE) == jax(d, True, jax_dataset.VALID_EXTENSIONS_ENHANCE)
    kw = dict(recursive=False, extensions=port_dataset.VALID_EXTENSIONS_ENHANCE)
    assert port(d, **kw) == jax(d, **kw) == sorted(str(tmp_path / n) for n in (
        "a.png", "b.JPG", "c.bmp", "d.tif", "e.tiff", "g.jpeg"))


@pytest.fixture(scope="module")
def bad_batch(tmp_path_factory):
    """Two good 128x128 images (PNG, JPEG), a JPEG cut in half and a file
    that is no image."""
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


@pytest.mark.parametrize("case", ["canvas_raises", "bad_file_gray_fills"])
def test_decode_raises_on_a_bad_file_or_canvas(images, bad_batch, case):
    if case == "canvas_raises":  # a plan that does not fit the canvas raises, as before
        with pytest.raises(ValueError, match="letterboxes to"):
            nl.decode_letterbox_batch_canvas(images["png"][:1], 640, 320, 320)
        return
    # A file that does not decode: its row gray 114 and one warning, the JAX
    # native loader's batch byte for byte; the cut JPEG decodes as libjpeg
    # decodes it (not gray), the non-image is gray.
    for port_fn, jax_fn, args in (
        (nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, (bad_batch, 128)),
        (nl.decode_letterbox_batch_canvas, jax_loader.decode_letterbox_batch_canvas, (bad_batch, 128, 128, 128)),
        (nl.decode_letterbox_batch, jax_loader.decode_letterbox_batch, (bad_batch, 96)),  # resized
    ):
        got, got_warn = _same_as_jax(port_fn, jax_fn, *args)
        assert got_warn == ["native loader: 1/4 images failed to decode (gray-filled)"]
        assert (got[2] == nl.GRAY_FILL).all() and not (got[1] == nl.GRAY_FILL).all()
    bucket, bucket_warn = _decoded(decode_bucket, bad_batch, 128, 128, 128, 2)
    want, _ = _decoded(nl.decode_letterbox_batch_canvas, bad_batch, 128, 128, 128)
    np.testing.assert_array_equal(bucket, want)
    assert bucket_warn == got_warn


def test_training_loader_batches_go_through_the_host_path(monkeypatch):
    """Each batch is one call of decode_letterbox_batch, whose bytes (the
    photos resized to 64) are the JAX native loader's."""
    ds = LowLightDataset(str(PHOTOS[0].parent), image_size=64)
    calls = []
    real = nl.decode_letterbox_batch
    monkeypatch.setattr(nl, "decode_letterbox_batch", lambda *a, **k: calls.append(a) or real(*a, **k))
    loader = TrainLoader(ds, batch_size=5, shuffle=True, num_workers=3, seed=7)
    order = TrainLoader(ds, batch_size=5, shuffle=True, seed=7).epoch_order()
    batches = list(loader)
    assert len(calls) == len(batches) == 5
    want = jax_loader.decode_letterbox_batch([ds.image_files[i] for i in order[:5]], 64, num_threads=2)
    np.testing.assert_array_equal(batches[0], want)


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
