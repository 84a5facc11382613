"""Bilinear resize with half-pixel centers on NHWC (or HWC) tensors.

Counterpart of ``retinex_tpu/ops/resize.py``: cv2 INTER_LINEAR /
``F.interpolate(align_corners=False)`` semantics, no antialiasing. The
output size is always given explicitly: ``resize_scale`` floors
``int(in * scale)`` itself, as the JAX package does, rather than passing a
``scale_factor`` whose source mapping would use the factor instead of the
size ratio. An exact integer downscale lands on one source row (odd factor)
or the midpoint of two (even factor), so it needs no special path here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW tensors (the models' layout)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images to (out_h, out_w)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = resize_bilinear_nchw(x.permute(0, 3, 1, 2), out_h, out_w).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def resize_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Resize NHWC by a scale factor with floor semantics: out = int(in * scale)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, int(h * scale), int(w * scale))


def resize_u8_round(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize a float image in [0,1], quantizing through the u8 grid before
    and after, like the reference letterbox's uint8 round trip."""
    y = resize_bilinear(torch.round(x * 255.0), out_h, out_w)
    return torch.clamp(torch.round(y), 0.0, 255.0) / 255.0
