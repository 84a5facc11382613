"""Inference with a trained net (``--mode predict``): one image or a directory.

Counterpart of ``retinex_tpu/infer/predict.py``: decode and letterbox, the
net's forward, and three PNGs per image, ``<name>_enhanced.png``,
``_illumination.png`` and a three-panel ``_comparison.png`` (input,
enhanced, illumination). No CLAHE: the enhanced image is the net's own.

``predict_batch`` runs a directory through the bucketed, pipelined loop of
directory enhance (``infer/batch_driver.py``), uint8 in and out of the
device; the floor quantisation on the device is the single-image route's
PNG truncation, so a batch writes the bytes single images would, wherever
the net's floats agree.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from retinex_tpu_torch.data.dataset import VALID_EXTENSIONS, list_image_files
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.infer.batch_driver import run_bucketed
from retinex_tpu_torch.infer.enhance import _quant, _synchronize, load_image
from retinex_tpu_torch.utils.viz import create_comparison, save_image


def _save(output_dir: str, path: str, img, enhanced, illu, save_comparison: bool, pool=None) -> None:
    """One image's PNGs, on `pool` at once where given (a single photo's),
    else one after another (a directory's, whose images run on a pool)."""
    name = os.path.splitext(os.path.basename(path))[0]
    base = os.path.join(output_dir, name)
    writes = [partial(save_image, enhanced, f"{base}_enhanced.png"), partial(save_image, illu, f"{base}_illumination.png")]
    if save_comparison:
        writes.append(partial(create_comparison, img, enhanced, illu, save_path=f"{base}_comparison.png"))
    if pool is None:
        for w in writes:
            w()
        return
    for f in [pool.submit(w) for w in writes]:
        f.result()


def predict_single_image(
    apply_fn,
    image_path: str,
    output_dir: str,
    max_size: int | None = None,
    save_comparison: bool = True,
    device: str | torch.device | None = None,
):
    """apply_fn: [B,H,W,3] -> (enhanced, reflectance, illumination).

    Returns (enhanced [H,W,3], illumination [H,W,1], seconds): the tensors
    on `device`, the seconds of the forward up to its result on the device
    (decode and PNG writes excluded)."""
    dev = resolve_device(device)
    img, _original = load_image(image_path, max_size)
    x = torch.from_numpy(img).to(dev)[None]

    start = time.perf_counter()
    enhanced, _refl, illu = apply_fn(x)
    _synchronize(dev)
    elapsed = time.perf_counter() - start
    print(f"Inference time: {elapsed:.4f}s")

    os.makedirs(output_dir, exist_ok=True)
    with ThreadPoolExecutor(max_workers=3) as pool:
        _save(output_dir, image_path, img, enhanced[0], illu[0], save_comparison, pool)
    return enhanced[0], illu[0], elapsed


def predict_batch(
    apply_fn,
    input_dir: str,
    output_dir: str,
    max_size: int | None = None,
    save_comparison: bool = True,
    batch_size: int = 8,
    num_workers: int = 8,
    device: str | torch.device | None = None,
    mesh=None,
) -> list[float]:
    """A directory, `batch_size` frames of one letterboxed canvas per call,
    the PNGs encoded on a pool of `num_workers` threads; with `mesh`, each
    chunk split over its devices (``infer/batch_driver.shard_batch_fn``).
    Returns per-image seconds (decode and writes excluded)."""
    dev = resolve_device(device)
    files = list_image_files(input_dir, recursive=False, extensions=VALID_EXTENSIONS)
    if not files:
        print(f"No images found in {input_dir}")
        return []
    print(f"Found {len(files)} images")

    os.makedirs(output_dir, exist_ok=True)
    saver = ThreadPoolExecutor(max_workers=num_workers)
    futures = []

    def fn(batch_u8: torch.Tensor):
        enhanced, _refl, illu = apply_fn(batch_u8.to(torch.float32) / 255.0)
        return _quant(enhanced), _quant(illu)

    def drain_cb(chunk, batch_u8, out_np):
        enh_u8, illu_u8 = out_np
        xf = batch_u8.astype(np.float32) / 255.0
        for j, path in enumerate(chunk):
            enh, illu = enh_u8[j].astype(np.float32) / 255.0, illu_u8[j].astype(np.float32) / 255.0
            futures.append(saver.submit(_save, output_dir, path, xf[j], enh, illu, save_comparison))

    timings = run_bucketed(
        files, max_size=max_size, batch_size=batch_size, fn=fn, drain_cb=drain_cb, device=dev, mesh=mesh,
        num_workers=num_workers,
    )
    for f in futures:
        f.result()
    saver.shutdown()
    total = sum(timings)
    print(f"Total: {total:.2f}s, avg {total / len(files):.4f}s/image")
    return timings
