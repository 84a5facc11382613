"""The enhance route of the port: decode, letterbox, net + Lab-CLAHE, PNGs.

Counterpart of ``retinex_tpu/infer/enhance.py``'s ``load_image`` and the
adaptive branch of ``enhance_single_image`` (the default route: no classical
mode, no enhancer flag). The content-aware and multi-scale enhancers and the
classical modes are not ported yet and raise, naming their ROADMAP item.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox
from retinex_tpu_torch.utils.viz import create_comparison, save_image


def load_image(image_path: str, max_size: int | None = None) -> tuple[np.ndarray, tuple[int, int]]:
    """Decode + letterbox. Returns ([H,W,3] float32 numpy in [0,1], (W, H)
    original size). Without max_size nothing is padded (the plan's target is
    the image's own size)."""
    with Image.open(image_path) as img:
        rgb = np.asarray(img.convert("RGB"))
    original_size = (rgb.shape[1], rgb.shape[0])
    h, w = rgb.shape[:2]
    target = max_size if max_size is not None else (h, w)
    plan = plan_letterbox(h, w, target, auto=True, scaleup=False)
    return letterbox_np(rgb, plan).astype(np.float32) / 255.0, original_size


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def enhance_single_image(
    apply_fn,
    image_path: str,
    output_dir: str,
    max_size: int | None = None,
    adjuster: AdaptiveParameterAdjuster | None = None,
    enable_multi_scale: bool = False,
    enable_content_aware: bool = False,
    classical_mode: str | None = None,
    save_outputs: bool = True,
    device: str | torch.device | None = None,
):
    """Enhance one image through the adaptive route (net, then Lab-CLAHE)
    and save the enhanced, illumination and comparison PNGs.

    Returns (enhanced [H,W,3], illumination [H,W,1], seconds), the tensors on
    `device` and the seconds from the image on the device to the result
    computed (decode and PNG writes excluded)."""
    dev = resolve_device(device)
    if classical_mode is not None:
        raise NotImplementedError(
            f"classical_mode={classical_mode!r}: the classical modes land in ROADMAP Queue 1 item 8"
        )
    if enable_content_aware or enable_multi_scale:
        raise NotImplementedError(
            "the content-aware and multi-scale enhancers land in ROADMAP Queue 1 item 8"
        )
    img, _original_size = load_image(image_path, max_size)
    x = torch.from_numpy(img).to(dev)

    start = time.perf_counter()
    adjuster = adjuster or AdaptiveParameterAdjuster()
    enhanced, illu = adjuster.apply_adaptive_enhancement(apply_fn, x)
    _synchronize(dev)
    elapsed = time.perf_counter() - start

    if save_outputs:
        os.makedirs(output_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(image_path))[0]
        save_image(enhanced, os.path.join(output_dir, f"{name}_enhanced.png"))
        save_image(illu, os.path.join(output_dir, f"{name}_illumination.png"))
        create_comparison(img, enhanced, save_path=os.path.join(output_dir, f"{name}_comparison.png"))
    return enhanced, illu, elapsed
