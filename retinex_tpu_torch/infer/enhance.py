"""The enhance routes of the port: one image or a directory, every pipeline.

Counterpart of ``retinex_tpu/infer/enhance.py``. One pipeline runs per
image, selected as in the JAX package:

- a classical mode (no net): ``ssr``, ``msr``, ``msrcr``
  (ops/retinex_classical.py), ``clahe`` (Lab-CLAHE, ops/clahe.py) or
  ``clahe_luma`` (ops/clahe_luma.py); luma stands in for the illumination;
- content-aware: net(x) * (1 + 0.2 * attention), attention from a
  |Laplacian| saliency map and 1/(luma+0.1);
- multi-scale: net(x) times one per-image scalar from 3-scale features;
- adaptive (default): Lab-CLAHE on the net output.

``enhance_batch_images`` runs a directory in chunks of one canvas each
(infer/batch_driver.py), uint8 in and uint8 out of the device.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.config import CLASSICAL_MODES
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.infer.adaptive_params import AdaptiveParameterAdjuster, gray_levels
from retinex_tpu_torch.ops.clahe import cell_divisible
from retinex_tpu_torch.ops.colorspace import rgb_to_luma
from retinex_tpu_torch.ops.filters import central_gradient, gaussian_blur, laplacian
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox
from retinex_tpu_torch.ops.resize import resize_bilinear
from retinex_tpu_torch.ops.retinex_classical import msr_enhance, ssr_enhance
from retinex_tpu_torch.utils.viz import create_comparison, save_image


def compute_saliency_map(x: torch.Tensor) -> torch.Tensor:
    """|Laplacian(gray_u8)| -> 15x15 Gaussian -> per-image min-max
    normalisation. x: [B,H,W,3] float [0,1] -> [B,H,W,1]."""
    gray = gray_levels(x)
    sal = gaussian_blur(torch.abs(laplacian(gray)), 15, 0.0)
    mn = torch.amin(sal, dim=(1, 2, 3), keepdim=True)
    mx = torch.amax(sal, dim=(1, 2, 3), keepdim=True)
    return (sal - mn) / (mx - mn + 1e-8)


def compute_attention_map(x: torch.Tensor) -> torch.Tensor:
    """saliency * 1/(luma+0.1), per-image min-max normalised."""
    att = compute_saliency_map(x) * (1.0 / (rgb_to_luma(x) + 0.1))
    mn = torch.amin(att, dim=(1, 2, 3), keepdim=True)
    mx = torch.amax(att, dim=(1, 2, 3), keepdim=True)
    return (att - mn) / (mx - mn + 1e-8)


def extract_multi_scale_features(x: torch.Tensor) -> list[torch.Tensor]:
    """Per-scale 7-channel features: RGB + Rec.601 luma + central-difference
    edge magnitude, at scales 1.0/0.5/0.25."""
    feats = []
    h, w = x.shape[1], x.shape[2]
    for scale in (1.0, 0.5, 0.25):
        xs = x if scale == 1.0 else resize_bilinear(x, int(h * scale), int(w * scale))
        gx = central_gradient(xs, axis=2)
        gy = central_gradient(xs, axis=1)
        feats.append(torch.cat([xs, rgb_to_luma(xs), torch.sqrt(gx * gx + gy * gy)], dim=-1))
    return feats


class ContentAwareEnhancer:
    """Saliency-guided content-aware boosting of the net output."""

    def apply_content_aware_enhancement(self, apply_fn, image: torch.Tensor):
        x = image
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        attention = compute_attention_map(x)
        enhanced, _refl, illu = apply_fn(x)
        out = torch.clamp(enhanced * (1.0 + 0.2 * attention), 0.0, 1.0)
        return (out[0], illu[0]) if squeeze else (out, illu)


class MultiScaleEnhancer:
    """Pyramid feature analysis -> one scalar adjustment per image."""

    def apply_multi_scale_enhancement(self, apply_fn, image: torch.Tensor):
        x = image
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        feats = extract_multi_scale_features(x)
        enhanced, _refl, illu = apply_fn(x)
        # Per-image means, so that images of one batch do not couple.
        adjustment = torch.ones((x.shape[0], 1, 1, 1), dtype=x.dtype, device=x.device)
        for w, f in zip((0.5, 0.3, 0.2), feats):
            adjustment = adjustment + w * torch.mean(f, dim=(1, 2, 3), keepdim=True) * 0.1
        out = torch.clamp(enhanced * adjustment, 0.0, 1.0)
        return (out[0], illu[0]) if squeeze else (out, illu)


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


def _classical_enhance(
    x: torch.Tensor,
    classical_mode: str,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
    mesh=None,
) -> torch.Tensor:
    """The no-net classical pipelines on a float [0,1] NHWC batch (or HWC).

    mesh: where given (the CLI's --spatial_shard with a CLAHE mode), each
    frame's height is split over its devices
    (``parallel/spatial.make_spatial_clahe``: K2's tables gathered, the rest
    slab by slab) where the mesh divides `tiles` and H, W are multiples of 2
    * tiles; other shapes say so and take the one-device route, as the JAX
    package does. The same bytes either way."""
    if mesh is not None and classical_mode in ("clahe", "clahe_luma"):
        from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_clahe, shard_rows

        squeeze = x.ndim == 3
        xb = x[None] if squeeze else x
        h, w = xb.shape[1], xb.shape[2]
        n = mesh.size
        if tiles % n == 0 and h % (2 * tiles) == 0 and w % (2 * tiles) == 0:
            fn = make_spatial_clahe(
                mesh, mode=classical_mode, clip_limit=clip_limit, tiles=tiles, hist_subsample=hist_subsample
            )
            out = gather_rows(fn(shard_rows(xb, mesh)), xb.device)
            return out[0] if squeeze else out
        print(
            f"spatial CLAHE needs H,W % {2 * tiles} == 0 and mesh | tiles; "
            f"got {(h, w)} on {n} devices — falling back to single-device"
        )
    if classical_mode == "ssr":
        return ssr_enhance(x)
    if classical_mode == "clahe":
        from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

        return clahe_lab_rgb(x, clip_limit=clip_limit, tiles=tiles, hist_subsample=hist_subsample)
    if classical_mode == "clahe_luma":
        from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb

        return clahe_luma_rgb(x, clip_limit=clip_limit, tiles=tiles, hist_subsample=hist_subsample)
    return msr_enhance(x, mode=classical_mode)


def _net_enhance(apply_fn, x: torch.Tensor, enable_multi_scale: bool, enable_content_aware: bool, adjuster=None):
    """The net pipelines, routed as the JAX package routes them."""
    if enable_content_aware:
        return ContentAwareEnhancer().apply_content_aware_enhancement(apply_fn, x)
    if enable_multi_scale:
        return MultiScaleEnhancer().apply_multi_scale_enhancement(apply_fn, x)
    return (adjuster or AdaptiveParameterAdjuster()).apply_adaptive_enhancement(apply_fn, x)


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
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
    device: str | torch.device | None = None,
    mesh=None,
):
    """Route one image through exactly one pipeline and save the enhanced,
    illumination and comparison PNGs. ``clip_limit``, ``tiles`` and
    ``hist_subsample`` apply to the ``clahe`` and ``clahe_luma`` modes; the
    adaptive route keeps its fixed 2.0 / 8x8. With `mesh` the CLAHE modes
    split the frame's height over its devices (``_classical_enhance``).

    Returns (enhanced [H,W,3], illumination [H,W,1], seconds), the tensors on
    `device` and the seconds from the image on the device to the result
    computed (decode and PNG writes excluded)."""
    dev = resolve_device(device)
    img, _original_size = load_image(image_path, max_size)
    x = torch.from_numpy(img).to(dev)

    start = time.perf_counter()
    if classical_mode in CLASSICAL_MODES:
        enhanced = _classical_enhance(x, classical_mode, clip_limit, tiles, hist_subsample, mesh)
        illu = rgb_to_luma(x)  # luminance stands in for the net's illumination map
    else:
        enhanced, illu = _net_enhance(apply_fn, x, enable_multi_scale, enable_content_aware, adjuster)
    _synchronize(dev)
    elapsed = time.perf_counter() - start

    if save_outputs:
        os.makedirs(output_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(image_path))[0]
        # The three PNGs at once (zlib releases the GIL while it compresses).
        with ThreadPoolExecutor(max_workers=3) as pool:
            writes = [
                pool.submit(save_image, enhanced, os.path.join(output_dir, f"{name}_enhanced.png")),
                pool.submit(save_image, illu, os.path.join(output_dir, f"{name}_illumination.png")),
                pool.submit(create_comparison, img, enhanced, save_path=os.path.join(output_dir, f"{name}_comparison.png")),
            ]
            for w in writes:
                w.result()
    return enhanced, illu, elapsed


def _quant(v: torch.Tensor) -> torch.Tensor:
    """floor(v * 255) to u8: save_image's truncation, so a batch writes the
    bytes the single-image route writes."""
    return torch.clamp(torch.floor(v * 255.0), 0, 255).to(torch.uint8)


def make_batch_pipeline(
    apply_fn,
    classical_mode: str | None = None,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
    enable_multi_scale: bool = False,
    enable_content_aware: bool = False,
):
    """uint8 NHWC batch -> (enhanced u8, illumination u8 or None), on the
    batch's device. The CLAHE modes take their u8 kernel routes on
    cell-divisible canvases (plain versions on the CPU): ``clahe`` K8 -> K2
    -> K8, ``clahe_luma`` K2 -> K7; every other case runs the float route
    and quantises. Both give the same bytes."""
    mode_key = classical_mode if classical_mode in CLASSICAL_MODES else "net"
    adjuster = AdaptiveParameterAdjuster()

    def fn(batch_u8: torch.Tensor):
        if mode_key in ("clahe", "clahe_luma") and cell_divisible(batch_u8.shape[1], batch_u8.shape[2], tiles, tiles):
            if mode_key == "clahe_luma":
                from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb_u8

                out = clahe_luma_rgb_u8(
                    batch_u8, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles, hist_subsample=hist_subsample
                )
            else:
                from retinex_tpu_torch.ops.clahe_gather import clahe_rgb_u8_gather

                out = clahe_rgb_u8_gather(
                    batch_u8, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles, hist_subsample=hist_subsample
                )
            return out, None
        x = batch_u8.to(torch.float32) / 255.0
        if mode_key in CLASSICAL_MODES:
            return _quant(_classical_enhance(x, mode_key, clip_limit, tiles, hist_subsample)), None
        out, illu = _net_enhance(apply_fn, x, enable_multi_scale, enable_content_aware, adjuster)
        return _quant(out), _quant(illu)

    return fn


def enhance_batch_images(
    apply_fn,
    input_dir: str,
    output_dir: str,
    max_size: int | None = None,
    classical_mode: str | None = None,
    batch_size: int = 8,
    num_workers: int = 8,
    save_outputs: bool = True,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
    enable_multi_scale: bool = False,
    enable_content_aware: bool = False,
    device: str | torch.device | None = None,
    mesh=None,
):
    """Batch enhance over a directory, `batch_size` frames per device call.

    Files are bucketed by letterboxed canvas (infer/batch_driver.py) and fed
    to the pipeline of ``make_batch_pipeline`` a chunk at a time: decode ->
    one batched call -> PNG encode on a thread pool of `num_workers`. With
    `mesh` (``parallel/mesh.py``) each chunk is split over its devices, the
    pipeline running whole on each slice (`apply_fn` then runs the copy of
    the weights on its input's device, ``parallel/mesh.replicate``): the
    same bytes. Returns per-image enhance timings (decode and saves
    excluded)."""
    from retinex_tpu_torch.data.dataset import VALID_EXTENSIONS_ENHANCE, list_image_files
    from retinex_tpu_torch.infer.batch_driver import run_bucketed

    dev = resolve_device(device)
    files = list_image_files(input_dir, recursive=False, extensions=VALID_EXTENSIONS_ENHANCE)
    if not files:
        print(f"No images found in {input_dir}")
        return []
    print(f"Found {len(files)} images")

    os.makedirs(output_dir, exist_ok=True)
    saver = ThreadPoolExecutor(max_workers=num_workers) if save_outputs else None
    futures = []

    def save_one(img_f32, enhanced, illu, path):
        name = os.path.splitext(os.path.basename(path))[0]
        save_image(enhanced, os.path.join(output_dir, f"{name}_enhanced.png"))
        save_image(illu, os.path.join(output_dir, f"{name}_illumination.png"))
        create_comparison(img_f32, enhanced, save_path=os.path.join(output_dir, f"{name}_comparison.png"))

    def drain_cb(chunk, batch_u8, out_np):
        if saver is None:
            return
        enh_np, illu_u8 = out_np
        xf = batch_u8.astype(np.float32) / 255.0
        if illu_u8 is not None:  # net modes: the model's illumination map
            illu_np = illu_u8.astype(np.float32) / 255.0
        else:
            # Classical modes: luma stands in for the illumination map,
            # computed on the host from the decoded bytes.
            illu_np = xf @ np.asarray([0.299, 0.587, 0.114], np.float32)
        for j, path in enumerate(chunk):
            futures.append(saver.submit(save_one, xf[j], enh_np[j].astype(np.float32) / 255.0, illu_np[j], path))

    timings = run_bucketed(
        files,
        max_size=max_size,
        batch_size=batch_size,
        fn=make_batch_pipeline(
            apply_fn, classical_mode, clip_limit, tiles, hist_subsample, enable_multi_scale, enable_content_aware
        ),
        drain_cb=drain_cb,
        device=dev,
        mesh=mesh,
        num_workers=num_workers,
    )
    if saver is not None:
        for f in futures:
            f.result()
        saver.shutdown()
    return timings
