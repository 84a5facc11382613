"""Plain reference of the enhance routes' decode and letterbox.

PIL decodes the file to RGB bytes. The letterbox is YOLO's: scale r =
min(target / h, target / w), never above 1 on the enhance routes, the
resized size rounded, the remaining height and width padded to a multiple
of 32 (``auto``), split top/bottom and left/right around the middle, gray
114. Without a target the frame is left as it is. A resize, where one is
needed, is bilinear with half-pixel centres, rounded to bytes.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def decode(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    in_h, in_w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1, x1 = np.minimum(y0 + 1, in_h - 1), np.minimum(x0 + 1, in_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return np.clip(np.round(top * (1 - wy) + bot * wy), 0, 255).astype(np.uint8)


def letterbox(img: np.ndarray, target: int | None) -> np.ndarray:
    """uint8 HWC -> the letterboxed uint8 canvas (no change without a target)."""
    if target is None:
        return img
    h, w = img.shape[:2]
    r = min(target / h, target / w, 1.0)
    nh, nw = int(round(h * r)), int(round(w * r))
    dh, dw = (target - nh) % 32, (target - nw) % 32
    top, left = int(round(dh / 2 - 0.1)), int(round(dw / 2 - 0.1))
    out = np.full((nh + dh, nw + dw, 3), 114, np.uint8)
    out[top : top + nh, left : left + nw] = img if (nh, nw) == (h, w) else _resize(img, nh, nw)
    return out
