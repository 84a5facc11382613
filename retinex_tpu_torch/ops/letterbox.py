"""YOLO-style letterbox: its geometry, the host-side u8 letterbox (numpy)
and the device letterbox (torch).

Counterpart of ``retinex_tpu/ops/letterbox.py``: ``plan_letterbox``
computes the resize and pad geometry from static shapes, ``letterbox_np``
applies it to a uint8 HWC image with a float64 half-pixel bilinear resize
and gray padding, and ``letterbox`` to float NHWC tensors on their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from retinex_tpu_torch.ops.colorspace import ieee_div
from retinex_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class LetterboxPlan:
    """Static letterbox geometry."""

    in_h: int
    in_w: int
    resize_h: int
    resize_w: int
    pad_top: int
    pad_bottom: int
    pad_left: int
    pad_right: int
    ratio: tuple[float, float]  # (width_ratio, height_ratio)
    dwdh: tuple[float, float]  # half-paddings (dw, dh)

    @property
    def out_h(self) -> int:
        return self.resize_h + self.pad_top + self.pad_bottom

    @property
    def out_w(self) -> int:
        return self.resize_w + self.pad_left + self.pad_right


def plan_letterbox(
    in_h: int,
    in_w: int,
    new_shape: int | tuple[int, int],
    auto: bool = True,
    scale_fill: bool = False,
    scaleup: bool = True,
    stride: int = 32,
) -> LetterboxPlan:
    """Compute letterbox geometry.

    auto=True pads only up to multiple-of-`stride` alignment, not to the
    full target square.
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / in_h, new_shape[1] / in_w)
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad_w, new_unpad_h = int(round(in_w * r)), int(round(in_h * r))
    dw = new_shape[1] - new_unpad_w
    dh = new_shape[0] - new_unpad_h
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad_w, new_unpad_h = new_shape[1], new_shape[0]
        ratio = (new_shape[1] / in_w, new_shape[0] / in_h)
    dw_half, dh_half = dw / 2.0, dh / 2.0
    top, bottom = int(round(dh_half - 0.1)), int(round(dh_half + 0.1))
    left, right = int(round(dw_half - 0.1)), int(round(dw_half + 0.1))
    return LetterboxPlan(
        in_h=in_h,
        in_w=in_w,
        resize_h=new_unpad_h,
        resize_w=new_unpad_w,
        pad_top=top,
        pad_bottom=bottom,
        pad_left=left,
        pad_right=right,
        ratio=ratio,
        dwdh=(dw_half, dh_half),
    )


def letterbox_np(img: np.ndarray, plan: LetterboxPlan) -> np.ndarray:
    """Letterbox a uint8 HWC numpy image: bilinear resize (half-pixel
    centers, rounded) then constant-114 padding."""
    if (plan.resize_h, plan.resize_w) != img.shape[:2]:
        img = _resize_bilinear_np_u8(img, plan.resize_h, plan.resize_w)
    out = np.full((plan.out_h, plan.out_w, img.shape[2]), 114, dtype=np.uint8)
    out[plan.pad_top : plan.pad_top + plan.resize_h, plan.pad_left : plan.pad_left + plan.resize_w] = img
    return out


def _resize_bilinear_np_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    in_h, in_w = img.shape[:2]
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * (in_h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * (in_w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


GRAY = 114.0 / 255.0  # the padding colour, (114, 114, 114)


def letterbox(x: torch.Tensor, plan: LetterboxPlan, quantize_u8: bool = True) -> torch.Tensor:
    """Apply a letterbox plan to float [0,1] NHWC (or HWC) images on their
    device. quantize_u8=True takes the reference's uint8 round trip
    (PARITY #12): the resize runs on the 0-255 grid and rounds, or, where
    the size stays, the values are rounded to it; False keeps the floats.
    The divisions by 255 are IEEE's (``ops/colorspace.ieee_div``), as in
    the JAX package's eager function."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if (plan.resize_h, plan.resize_w) != (x.shape[1], x.shape[2]):
        if quantize_u8:
            y = resize_bilinear(torch.round(x * 255.0), plan.resize_h, plan.resize_w)
            x = ieee_div(torch.clamp(torch.round(y), 0.0, 255.0), 255.0)
        else:
            x = resize_bilinear(x, plan.resize_h, plan.resize_w)
    elif quantize_u8:
        x = ieee_div(torch.round(x * 255.0), 255.0)
    pad = (plan.pad_left, plan.pad_right, plan.pad_top, plan.pad_bottom)
    x = F.pad(x.permute(0, 3, 1, 2), pad, value=float(np.float32(GRAY))).permute(0, 2, 3, 1)
    return x[0] if squeeze else x
