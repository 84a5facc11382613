"""The host path: threaded decode and letterbox, and a fast PNG writer.

Counterpart of ``retinex_tpu/data/native_loader.py``, with its public
names. The JAX package binds a C++ library there (libjpeg-turbo and libpng
decode, letterbox and encode in C++ threads, built from ``native/``). The
port builds no library and reads nothing under ``native/``:

- ``decode_letterbox_batch`` and ``decode_letterbox_batch_canvas`` decode
  (PIL) and letterbox (``ops/letterbox.letterbox_np``) a batch on a pool of
  ``num_threads`` threads, each image written into its row of the batch.
  PIL releases the GIL while it decodes, and the letterbox's numpy resize
  for most of its work, so the threads run at once. The bytes are those of
  the serial path (``dataset.decode_image`` then ``letterbox_np``). A file
  that does not decode fills its row with gray 114, and the call warns
  once, ``native loader: k/n images failed to decode (gray-filled)``, as
  the JAX native loader does; a JPEG whose data ends early decodes as
  libjpeg's stdio source decodes it there (an EOI marker after the last
  byte), the JAX native loader's bytes. An image that does not letterbox
  to the batch's canvas raises.
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
import struct
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox

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
# What opening or decoding a file that is missing, no image or damaged
# raises (PIL's UnidentifiedImageError and "image file is truncated" are
# OSErrors): the row is gray-filled, as the native loader fills it.
_DECODE_ERRORS = (OSError, EOFError, SyntaxError, ValueError, Image.DecompressionBombError)


def _decode_or_none(path: str) -> np.ndarray | None:
    """RGB uint8 HWC, or None where the file does not decode. A JPEG cut
    short that PIL refuses is decoded once more with an EOI marker after
    its last byte, which is what libjpeg's stdio source feeds the decoder at
    a premature end of file."""
    from retinex_tpu_torch.data.dataset import decode_image

    try:
        return decode_image(path)
    except _DECODE_ERRORS:
        pass
    try:
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_JPEG_SOI) or data.endswith(_JPEG_EOI):
            return None
        with Image.open(io.BytesIO(data + _JPEG_EOI)) as img:
            return np.asarray(img.convert("RGB"))
    except _DECODE_ERRORS:
        return None


def _decode_into(out: np.ndarray, paths: list[str], plan_for, num_threads: int) -> np.ndarray:
    """Decode and letterbox each path into out[i] on `num_threads` threads;
    plan_for(h, w) gives an image's letterbox plan. A path that does not
    decode leaves its row GRAY_FILL and the call warns once."""

    def one(i: int) -> bool:
        rgb = _decode_or_none(paths[i])
        if rgb is None:
            out[i] = GRAY_FILL
            return False
        plan = plan_for(rgb.shape[0], rgb.shape[1])
        if (plan.out_h, plan.out_w) != out.shape[1:3]:
            raise ValueError(
                f"{paths[i]} letterboxes to {(plan.out_h, plan.out_w)}, not the batch's canvas {out.shape[1:3]}"
            )
        out[i] = letterbox_np(rgb, plan)
        return True

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
    return _decode_into(
        out, paths, lambda h, w: plan_letterbox(h, w, image_size, auto=auto_pad, scaleup=scaleup), num_threads
    )


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
    return _decode_into(
        out, paths, lambda h, w: plan_letterbox(h, w, new_shape, auto=auto_pad, scaleup=scaleup), num_threads
    )


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
