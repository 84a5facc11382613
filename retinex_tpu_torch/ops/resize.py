"""Bilinear resize with half-pixel centers on NHWC (or HWC) tensors.

Counterpart of ``retinex_tpu/ops/resize.py``: cv2 INTER_LINEAR /
``F.interpolate(align_corners=False)`` semantics, no antialiasing. The
output size is always given explicitly: ``resize_scale`` floors
``int(in * scale)`` itself, as the JAX package does, rather than passing a
``scale_factor`` whose source mapping would use the factor instead of the
size ratio. An exact integer downscale lands on one source row (odd factor)
or the midpoint of two (even factor), so it needs no special path in f32.

A bf16 tensor is resized as the JAX package resizes it in bf16 (the
``--use_amp`` net's feature maps): an exact integer downscale by its strided
slice or two-row mean in bf16, anything else as ``jax.image.resize`` does
it, by weight matrices computed in f32 and rounded to bf16, contracted
along W first and then along H, each product summed in f32 and rounded to
bf16 (``tests/test_torch_amp_net.py`` holds it to JAX bit for bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from retinex_tpu_torch.ops import bf16


@functools.lru_cache(maxsize=64)
def _weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 triangle weights of ``jax.image.resize``'s
    ``compute_weight_mat`` (no antialias), in its f32 operations."""
    inv = np.float32(1.0 / (n_out / n_in))
    f32 = np.float32
    s = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv - f32(0.5)
    w = np.maximum(f32(0), f32(1) - np.abs(s[None, :] - np.arange(n_in, dtype=f32)[:, None]))
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps, w / np.where(tot != 0, tot, f32(1)), f32(0))
    return np.where(((s >= -0.5) & (s <= n_in - 0.5))[None, :], w, f32(0)).astype(f32)


def _exact_down(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """The JAX package's integer downscale by k along `axis`, in x.dtype."""
    if k == 1:
        return x
    n = x.shape[axis] // k
    g = x.narrow(axis, 0, n * k).unflatten(axis, (n, k))
    if k % 2:
        return g.select(axis + 1, (k - 1) // 2)
    return (g.select(axis + 1, k // 2 - 1) + g.select(axis + 1, k // 2)) * 0.5


def _resize_reduced(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW x in a reduced dtype, resized as the JAX package does in it."""
    h, w = x.shape[-2:]
    if out_h and out_w and h % out_h == 0 and w % out_w == 0 and (h > out_h or w > out_w):
        return _exact_down(_exact_down(x, h // out_h, 2), w // out_w, 3)
    dt = x.dtype
    if w != out_w:
        x = bf16.einsum("bchw,wv->bchv", x, torch.from_numpy(_weights(w, out_w)).to(x.device), dt)
    if h != out_h:
        x = bf16.einsum("bchw,hu->bcuw", x, torch.from_numpy(_weights(h, out_h)).to(x.device), dt)
    return x


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW tensors (the models' layout)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    if x.dtype != torch.float32:
        return _resize_reduced(x, out_h, out_w)
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
