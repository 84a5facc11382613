"""The host path: threaded decode and letterbox, and a fast PNG writer.

Counterpart of ``retinex_tpu/data/native_loader.py``, with its public
names. The JAX package binds a C++ library there (libjpeg-turbo and libpng
decode, letterbox and encode in C++ threads, built from ``native/``). The
port builds no library and reads nothing under ``native/``; it gives that
library's bytes with PIL and numpy:

- ``decode_letterbox_batch`` and ``decode_letterbox_batch_canvas`` decode
  and letterbox a batch on a pool of ``num_threads`` threads, each image
  written into its row of the batch. PIL releases the GIL while it decodes,
  and numpy while it resizes, so the threads run at once.
- The format is chosen by the file's first bytes, as the C++ loader chooses
  it, whatever the extension: ``FF D8`` is JPEG, the 8-byte PNG signature
  is PNG, and every other file (BMP, TIFF, WebP, GIF, ...) does not decode.
  A JPEG that libjpeg cannot deliver as RGB (CMYK, YCCK) does not decode; a
  JPEG whose data ends early decodes as libjpeg's stdio source decodes it
  (an EOI marker after the last byte). A PNG is normalised as libpng is set
  up there: palette and tRNS expanded, 1-, 2- and 4-bit gray to 8 bits,
  16-bit samples to their high byte, gray to RGB, alpha dropped. PIL's
  decompression-bomb check is not applied: the C++ loader has none.
- A file that does not decode fills its row with gray 114, and the call
  warns once, ``native loader: k/n images failed to decode (gray-filled)``.
- The letterbox is the C++ loader's (``letterbox_into``): its geometry
  rounds halves away from zero, and ``resize_bilinear_u8`` is its f32
  half-pixel bilinear resize, rounded as ``std::lround`` rounds. Both differ
  from ``ops/letterbox.letterbox_np`` (f64, halves to even), which the
  single-image routes keep, as the JAX package's do. An image whose plan
  (``plan_letterbox``) does not letterbox to the batch's canvas raises; one
  whose C++ geometry does not fit the canvas (a rounding tie) is gray-filled
  and counted, as the C++ loader fills it.
- ``encode_png`` writes an RGB PNG (or a gray one, of a 2-D array, as PIL
  writes those) with Python's ``zlib`` and numpy: the
  signature, IHDR, one IDAT of the rows SUB-filtered, deflated at zlib
  level ``level`` with the default strategy (the JAX package's defaults,
  the only filter and strategy it takes), IEND. zlib releases the GIL while it
  compresses, so the three PNGs of a photo are written at once on three
  threads (``infer/enhance.py``, ``infer/predict.py``). Its files decode to
  the same pixels as PIL's; their bytes differ from PIL's and libpng's.

``native_available`` is always True: this module is the host path, and
there is nothing that could be missing.
"""

from __future__ import annotations

import io
import math
import struct
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, JpegImagePlugin, PngImagePlugin

from retinex_tpu_torch.ops.letterbox import plan_letterbox

# PNG encode defaults, the JAX package's: zlib level 1, the SUB filter,
# the default deflate strategy.
PNG_LEVEL = 1
PNG_FILTER_SUB = 1
PNG_STRATEGY_DEFLATE = 0

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def native_available() -> bool:
    """True: the port's host path is this module (PIL decode on threads,
    zlib encode); no native library is built or loaded."""
    return True


# The value of a row whose file does not decode, the JAX native loader's.
GRAY_FILL = 114

_JPEG_SOI, _JPEG_EOI = b"\xff\xd8", b"\xff\xd9"
# What decoding a file that is missing, no image or damaged raises (PIL's
# "image file is truncated" is an OSError): the row is gray-filled.
_DECODE_ERRORS = (OSError, EOFError, SyntaxError, ValueError)
# PIL's mode of a 16-bit gray PNG ("I" in older Pillow): libpng keeps the
# high byte, where PIL's convert("RGB") clips to 255.
_GRAY16_MODES = ("I;16", "I")


def _jpeg_rgb(data: bytes) -> np.ndarray | None:
    """libjpeg's JCS_RGB output: gray is replicated, CMYK and YCCK (PIL's
    CMYK) cannot be delivered."""
    with JpegImagePlugin.JpegImageFile(io.BytesIO(data)) as im:
        return None if im.mode == "CMYK" else np.asarray(im.convert("RGB"))


def _png_rgb(data: bytes) -> np.ndarray:
    """The libpng set-up of the C++ loader's decode_png, on PIL's decode:
    PIL expands palettes and low-bit gray as libpng does, keeps the high
    byte of 16-bit RGB, RGBA and gray+alpha samples and drops alpha (tRNS
    included) in convert("RGB"); a 16-bit gray image takes its high byte
    here."""
    with PngImagePlugin.PngImageFile(io.BytesIO(data)) as im:
        if im.mode in _GRAY16_MODES:
            g = (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)
            return np.repeat(g[:, :, None], 3, axis=2)
        return np.asarray(im.convert("RGB"))


def decode_file(path: str) -> np.ndarray | None:
    """RGB uint8 HWC as the C++ loader's ``decode_file`` decodes `path`,
    or None where it does not decode. The first bytes choose the decoder
    (JPEG, PNG, or none); a JPEG cut short that PIL refuses is decoded once
    more with an EOI marker after its last byte, which is what libjpeg's
    stdio source feeds the decoder at a premature end of file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(_JPEG_SOI):
            try:
                return _jpeg_rgb(data)
            except _DECODE_ERRORS:
                if data.endswith(_JPEG_EOI):
                    return None
                return _jpeg_rgb(data + _JPEG_EOI)
        if data.startswith(_SIGNATURE):
            return _png_rgb(data)
    except _DECODE_ERRORS:
        pass
    return None


def _lround(x: float) -> int:
    """C's lround: to the nearest integer, halves away from zero."""
    t = math.trunc(x)
    d = x - t  # exact
    return t + (d >= 0.5) - (d <= -0.5)


def _axis(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One axis of the C++ resize: source index pairs from f64 half-pixel
    coordinates, clamped; the weights cast to f32, 1 - w in f32."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = np.clip(s - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, np.float32(1.0) - w1, w1


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The C++ loader's bilinear resize of a uint8 HWC image (half-pixel
    centres): every product and sum in f32, in its order, with no fused
    multiply-add (numpy rounds each operation), then rounded as
    ``std::lround`` rounds the f32 value (halves away from zero) and
    clamped to [0, 255]."""
    in_h, in_w = img.shape[:2]
    y0, y1, fy0, fy1 = _axis(in_h, out_h)
    x0, x1, fx0, fx1 = _axis(in_w, out_w)
    fx0, fx1 = fx0[None, :, None], fx1[None, :, None]
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] * fx0  # u8 * f32 -> f32, as the C++ int * float
    top += r0[:, x1] * fx1
    bot = r1[:, x0] * fx0
    bot += r1[:, x1] * fx1
    top *= fy0[:, None, None]
    bot *= fy1[:, None, None]
    v = top
    v += bot
    t = np.trunc(v)
    v -= t  # the fraction, exact; v >= 0
    t += v >= 0.5
    return np.clip(t, 0, 255).astype(np.uint8)


def letterbox_into(img: np.ndarray, new_shape: int, auto_pad: bool, scaleup: bool, dst: np.ndarray) -> bool:
    """The C++ loader's letterbox of a uint8 HWC image into the canvas
    `dst` [out_h, out_w, 3]: its geometry (``plan_letterbox``'s, with C's
    lround), gray 114 around, the image copied where its size stays, else
    resized by ``resize_bilinear_u8``. Returns False, and writes nothing,
    where the geometry does not fit the canvas."""
    h, w = img.shape[:2]
    r = min(new_shape / h, new_shape / w)
    if not scaleup:
        r = min(r, 1.0)
    uw, uh = _lround(w * r), _lround(h * r)
    dw, dh = new_shape - uw, new_shape - uh
    if auto_pad:
        dw, dh = dw % 32, dh % 32
    top, left = _lround(dh / 2.0 - 0.1), _lround(dw / 2.0 - 0.1)
    if uh + top > dst.shape[0] or uw + left > dst.shape[1]:
        return False
    dst[...] = GRAY_FILL
    if uh > 0 and uw > 0:
        dst[top : top + uh, left : left + uw] = img if (uh, uw) == (h, w) else resize_bilinear_u8(img, uh, uw)
    return True


def _decode_into(
    out: np.ndarray, paths: list[str], new_shape: int, auto_pad: bool, scaleup: bool, num_threads: int
) -> np.ndarray:
    """Decode and letterbox each path into out[i] on `num_threads` threads.
    A path that does not decode, or whose C++ geometry does not fit, leaves
    its row GRAY_FILL and the call warns once; one whose plan does not
    letterbox to the canvas raises."""

    def one(i: int) -> bool:
        rgb = decode_file(paths[i])
        if rgb is not None:
            plan = plan_letterbox(rgb.shape[0], rgb.shape[1], new_shape, auto=auto_pad, scaleup=scaleup)
            if (plan.out_h, plan.out_w) != out.shape[1:3]:
                raise ValueError(
                    f"{paths[i]} letterboxes to {(plan.out_h, plan.out_w)}, not the batch's canvas {out.shape[1:3]}"
                )
            if letterbox_into(rgb, new_shape, auto_pad, scaleup, out[i]):
                return True
        out[i] = GRAY_FILL
        return False

    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        ok = sum(f.result() for f in [pool.submit(one, i) for i in range(len(paths))])
    n = len(paths)
    if ok < n:
        warnings.warn(f"native loader: {n - ok}/{n} images failed to decode (gray-filled)")
    return out


def decode_letterbox_batch(
    paths: list[str],
    image_size: int,
    auto_pad: bool = False,
    scaleup: bool = True,
    num_threads: int = 8,
) -> np.ndarray:
    """Decode + letterbox `paths` into a [N, image_size, image_size, 3]
    uint8 NHWC batch on `num_threads` threads (the training loader's)."""
    out = np.empty((len(paths), image_size, image_size, 3), dtype=np.uint8)
    return _decode_into(out, paths, image_size, auto_pad, scaleup, num_threads)


def decode_letterbox_batch_canvas(
    paths: list[str],
    new_shape: int,
    out_h: int,
    out_w: int,
    auto_pad: bool = True,
    scaleup: bool = False,
    num_threads: int = 8,
) -> np.ndarray:
    """Decode + letterbox into a non-square [N, out_h, out_w, 3] canvas.

    Every path must plan-letterbox (target `new_shape`, given auto_pad and
    scaleup) to exactly (out_h, out_w), as the batched drivers' buckets do
    (``infer/batch_driver.py``); one that does not raises ValueError."""
    out = np.empty((len(paths), out_h, out_w, 3), dtype=np.uint8)
    return _decode_into(out, paths, new_shape, auto_pad, scaleup, num_threads)


def _sub_filtered_rows(img_u8: np.ndarray) -> np.ndarray:
    """The rows of an [H, W, C] image SUB-filtered for an IDAT, [H, 1 + C W]
    u8, each row led by its filter type 1. The filter reads the raw bytes
    only, so every row is filtered at once."""
    h, w, ch = img_u8.shape
    raw = img_u8.reshape(h, ch * w)
    out = np.empty((h, 1 + ch * w), np.uint8)
    out[:, 0] = PNG_FILTER_SUB
    out[:, 1 : 1 + ch] = raw[:, :ch]
    np.subtract(raw[:, ch:], raw[:, :-ch], out=out[:, 1 + ch :])  # u8 arithmetic wraps, as PNG's filters do
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(
    img_u8: np.ndarray,
    path: str,
    level: int = PNG_LEVEL,
    filters: int = PNG_FILTER_SUB,
    strategy: int = PNG_STRATEGY_DEFLATE,
) -> bool:
    """Write one [H,W,3] uint8 RGB array as an 8-bit RGB PNG at `path` (an
    [H,W] array as an 8-bit gray PNG): the rows SUB-filtered, deflated at
    zlib `level`, in one IDAT. `filters` and `strategy` keep the JAX
    signature and take only their defaults. Returns True; raises ValueError
    on an array of another shape or dtype or another filter or strategy, and
    OSError where the file cannot be written."""
    gray = img_u8.ndim == 2
    if img_u8.dtype != np.uint8 or not (gray or (img_u8.ndim == 3 and img_u8.shape[2] == 3)):
        raise ValueError(f"encode_png: expected uint8 [H, W, 3] or [H, W], got {img_u8.dtype} {img_u8.shape}")
    if (filters, strategy) != (PNG_FILTER_SUB, PNG_STRATEGY_DEFLATE):
        raise ValueError(f"encode_png writes the SUB filter (1), default strategy (0); got {(filters, strategy)}")
    h, w = img_u8.shape[:2]
    rows = _sub_filtered_rows(np.ascontiguousarray(img_u8).reshape(h, w, -1))
    idat = zlib.compress(rows.tobytes(), level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
    return True
