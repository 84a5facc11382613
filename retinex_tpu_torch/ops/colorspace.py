"""Colorspace conversions in PyTorch (HWC/NHWC float in [0,1] unless noted).

Counterpart of ``retinex_tpu/ops/colorspace.py``: OpenCV-style 8-bit Lab with
the sRGB de-gamma, the D65 matrices, CIE f() and its inverse.

The 3x3 transforms are explicit multiply-adds, never a matmul: matmul units
(cuBLAS TF32, oneDNN) may run small f32 contractions at reduced precision,
which the cbrt and x500 scaling would amplify into u8 flips.

The per-channel helpers (``linear_rgb_to_lab8`` / ``lab8_to_linear_rgb``) take
and return separate channel tensors so the channel-last public functions and
the planar CLAHE plain versions (ops/clahe_gather.py) share one arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Rec.601 luma weights.
_REC601 = (0.299, 0.587, 0.114)

# Linear RGB -> XYZ (D65), the matrix OpenCV uses for Lab.
RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
XN = 0.950456  # D65 white point (X), OpenCV constant
ZN = 1.088754  # D65 white point (Z), OpenCV constant


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a float32 x, rounded as IEEE float32 division rounds it,
    on any device.

    PyTorch on CUDA divides a tensor by a Python number as a product by the
    number's reciprocal, which rounds some quotients the other way (126 of
    the 256 bytes / 255); on the CPU it divides. In float64 the quotient
    (or CUDA's product) is within 2^-52 of x / c, and an f32 quotient of two
    f32 numbers lies at least 2^-49 (relative) from a point where rounding
    to f32 changes, so its one rounding to f32 is the IEEE quotient's on
    both devices. c is taken as the f32 number the CPU's division uses."""
    return (x.double() / float(np.float32(c))).float()


def rgb_to_luma(x: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma. x: [..., 3] in [0,1] -> [..., 1]."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return (r * _REC601[0] + g * _REC601[1] + b * _REC601[2])[..., None]


def saturation_map(x: torch.Tensor) -> torch.Tensor:
    """HSV-style saturation (max-min)/max per pixel, 0 where max ~ 0.
    x: [..., 3] -> [...]."""
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    return torch.where(mx > 1e-8, (mx - mn) / torch.clamp(mx, min=1e-8), 0.0)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer: de-gamma to linear light."""
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`srgb_to_linear` (gamma encode)."""
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1.0 / 2.4) - 0.055)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: take t**(1/3) in float64 and round once to float32,
    # which is within an ulp of a correctly rounded f32 cube root (t > 0).
    return torch.pow(t.double(), 1.0 / 3.0).to(t.dtype)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    # CIE f(t): cube root above the linear-domain threshold, affine below.
    return torch.where(t > 0.008856, _cbrt(torch.clamp(t, min=1e-12)), 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft * ft * ft, (ft - 16.0 / 116.0) / 7.787)


def linear_rgb_to_lab8(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Linear-light RGB channels -> (L, a, b) float in OpenCV's 8-bit scale
    (the white-point divisions IEEE's on every device, ``ieee_div``)."""
    m = RGB2XYZ
    X = ieee_div(m[0][0] * r + m[0][1] * g + m[0][2] * b, XN)
    Y = m[1][0] * r + m[1][1] * g + m[1][2] * b
    Z = ieee_div(m[2][0] * r + m[2][1] * g + m[2][2] * b, ZN)
    fx, fy, fz = _lab_f(X), _lab_f(Y), _lab_f(Z)
    L = 116.0 * fy - 16.0
    return L * (255.0 / 100.0), 500.0 * (fx - fy) + 128.0, 200.0 * (fy - fz) + 128.0


def lab8_fy(L8: torch.Tensor) -> torch.Tensor:
    """fy of OpenCV's 8-bit L."""
    return (L8 * (100.0 / 255.0) + 16.0) / 116.0


def lab8_da(a8: torch.Tensor) -> torch.Tensor:
    """fx - fy of OpenCV's 8-bit a."""
    return (a8 - 128.0) / 500.0


def lab8_db(b8: torch.Tensor) -> torch.Tensor:
    """fy - fz of OpenCV's 8-bit b."""
    return (b8 - 128.0) / 200.0


def lab8_to_linear_rgb(L8: torch.Tensor, a8: torch.Tensor, b8: torch.Tensor):
    """(L, a, b) in OpenCV's 8-bit scale -> linear-light RGB channels.

    fy, fx - fy and fy - fz each depend on one channel (``lab8_fy``,
    ``lab8_da``, ``lab8_db``), so K3 reads them from 256-entry tables."""
    fy = lab8_fy(L8)
    fx = fy + lab8_da(a8)
    fz = fy - lab8_db(b8)
    Y = _lab_f_inv(fy)
    X = _lab_f_inv(fx) * XN
    Z = _lab_f_inv(fz) * ZN
    m = XYZ2RGB
    return tuple(m[c][0] * X + m[c][1] * Y + m[c][2] * Z for c in range(3))


def rgb_to_lab_u8(x: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] float -> OpenCV-style 8-bit-scaled Lab floats [..., 3].

    Matches cv2.cvtColor(img_u8, COLOR_RGB2LAB) semantics; returns floats so
    the caller controls rounding (round + clip recovers the u8 values).
    """
    x = srgb_to_linear(x.float())
    return torch.stack(linear_rgb_to_lab8(x[..., 0], x[..., 1], x[..., 2]), dim=-1)


@functools.lru_cache(maxsize=None)
def degamma_table(device: str) -> torch.Tensor:
    """f32 [256]: srgb_to_linear(v / 255) for every byte v, computed on the
    CPU (on CUDA the division and the power round some values otherwise)."""
    v = torch.arange(256, dtype=torch.float32) / 255.0
    return srgb_to_linear(v).to(device)


def srgb_bytes_to_lab_u8(rgb: torch.Tensor, dim: int) -> torch.Tensor:
    """sRGB bytes (an integer tensor, channels along `dim`) -> OpenCV 8-bit
    Lab bytes, channels along `dim`: ``degamma_table``, then
    ``linear_rgb_to_lab8`` rounded and clipped. The same bytes on the CPU
    and on the card; K1's plain version and the plain Lab-CLAHE route."""
    tab = degamma_table(str(rgb.device))
    r, g, b = (tab[c.long()] for c in rgb.unbind(dim))
    lab = linear_rgb_to_lab8(r, g, b)
    return torch.stack([torch.clamp(torch.round(ch), 0, 255) for ch in lab], dim=dim).to(torch.uint8)


def lab_u8_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_lab_u8`. lab in 8-bit scale -> RGB [0,1]."""
    lab = lab.float()
    rgb = torch.stack(lab8_to_linear_rgb(lab[..., 0], lab[..., 1], lab[..., 2]), dim=-1)
    return torch.clamp(linear_to_srgb(rgb), 0.0, 1.0)
