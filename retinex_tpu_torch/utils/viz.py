"""Result images: saved outputs and side-by-side comparisons.

Counterpart of ``retinex_tpu/utils/viz.py`` (``save_image``,
``create_comparison``, ``visualize_results``, ``create_gif``) on NHWC/HWC
arrays or tensors in [0,1]. PNGs are
written by ``data/native_loader.encode_png`` (zlib level 1, the SUB filter
on every row: the JAX package's native encoder's settings): encoding the
PNGs is most of the end-to-end time of one image (PERF.md). The pixels are
those the JAX package writes, including the u8 floor truncation ``(arr * 255).astype(uint8)``. A
bf16 image (the ``--use_amp`` packed net's illumination) is quantised as
the JAX package's numpy bf16 array is: clipped, times 255 rounded to bf16,
then truncated; the comparison panels take its exact f32 values, as
numpy's concatenation with f32 panels does.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.data.native_loader import encode_png


def _write_png(arr_u8: np.ndarray, save_path: str) -> None:
    encode_png(arr_u8, save_path)


def _to_hwc(img) -> np.ndarray:
    """[H,W,C] or [1,H,W,C] array/tensor in [0,1] -> clipped HWC numpy
    (f32 for a bf16 tensor, which numpy cannot hold)."""
    if isinstance(img, torch.Tensor):
        t = img.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    return np.clip(arr, 0.0, 1.0)


def save_image(img, save_path: str) -> None:
    """Save a [0,1] float image as PNG; one-channel images are replicated to RGB."""
    if isinstance(img, torch.Tensor) and img.dtype == torch.bfloat16:
        t = img.detach().cpu()
        u8 = (torch.clamp(t[0] if t.ndim == 4 else t, 0.0, 1.0) * 255).to(torch.uint8).numpy()  # * 255 in bf16
    else:
        u8 = (_to_hwc(img) * 255).astype(np.uint8)
    if u8.shape[-1] == 1:
        u8 = np.repeat(u8, 3, axis=-1)
    _write_png(u8, save_path)


def create_comparison(img_low, img_enhanced, illu_map=None, save_path: str | None = None) -> np.ndarray:
    """Horizontal [input | enhanced | (illumination)] strip as uint8 RGB;
    saves it if save_path is given, and returns it."""
    panels = [_to_hwc(img_low), _to_hwc(img_enhanced)]
    if illu_map is not None:
        illu = _to_hwc(illu_map)
        if illu.shape[-1] != 1:
            illu = illu.mean(axis=-1, keepdims=True)
        panels.append(np.repeat(illu, 3, axis=-1))
    strip = (np.concatenate(panels, axis=1) * 255).astype(np.uint8)
    if save_path:
        _write_png(strip, save_path)
    return strip


def visualize_results(img_low, img_enhanced, illu_map, save_path: str | None = None) -> np.ndarray:
    """Three panels side by side: input, enhanced, illumination (gray);
    the JAX package's matplotlib figure as a PIL strip (no matplotlib on
    the card's machine), under the same file name. Returns the strip."""
    illu = _to_hwc(illu_map)
    illu_gray = illu.mean(axis=-1, keepdims=True) if illu.ndim == 3 else illu[..., None]
    panels = [_to_hwc(img_low), _to_hwc(img_enhanced), np.repeat(illu_gray, 3, axis=-1)]
    strip = (np.concatenate(panels, axis=1) * 255).astype(np.uint8)
    if save_path:
        _write_png(strip, save_path)
    return strip


def create_gif(image_paths: list[str], output_path: str, duration: int = 500) -> None:
    """Animated GIF from image files."""
    images = [Image.open(p) for p in image_paths]
    images[0].save(output_path, save_all=True, append_images=images[1:], duration=duration, loop=0)
