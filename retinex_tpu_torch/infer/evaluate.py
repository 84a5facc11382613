"""Image-quality evaluation of a directory (``--mode evaluate``).

Counterpart of ``retinex_tpu/infer/evaluate.py``: the no-reference bundle
(brightness, contrast, entropy, NIQE, saturation, naturalness) for every
image in a directory, plus PSNR, SSIM and MSE against a reference directory
when one is given (matched by file name and decoded size). Images are
bucketed by decoded size and by whether a reference exists, and go to the
device ``batch_size`` at a time as uint8. Writes ``metrics.csv`` when asked
and prints a summary, with the JAX package's keys, order and columns.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.data.dataset import VALID_EXTENSIONS, decode_image, list_image_files
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.ops.metrics import calculate_metrics

NO_REF_KEYS = ("mean_brightness", "contrast", "entropy", "niqe", "saturation", "naturalness")
REF_KEYS = ("psnr", "ssim", "mse")


def _image_size(path: str) -> tuple[int, int]:
    with Image.open(path) as im:
        w, h = im.size
    return h, w


def evaluate_directory(
    input_dir: str,
    reference_dir: str | None = None,
    output_csv: str | None = None,
    batch_size: int = 16,
    device: str | torch.device | None = None,
    mesh=None,
) -> list[dict]:
    """One dict per image ({"image": name, metric: float, ...}), in sorted
    file order; optionally writes them as a CSV. With `mesh` each chunk is
    split over its devices (``infer/batch_driver.shard_batch_fn``)."""
    from retinex_tpu_torch.infer.batch_driver import fetch, pad_for_mesh, shard_batch_fn

    dev = resolve_device(device)
    files = list_image_files(input_dir, recursive=False, extensions=VALID_EXTENSIONS)
    if not files:
        raise ValueError(f"No images found in {input_dir}")

    def ref_for(path: str, size: tuple[int, int]) -> str | None:
        if reference_dir is None:
            return None
        rp = os.path.join(reference_dir, os.path.basename(path))
        if os.path.exists(rp) and _image_size(rp) == size:
            return rp
        return None

    buckets: dict[tuple[int, int, bool], list[tuple[str, str | None]]] = {}
    for path in files:
        h, w = _image_size(path)
        rp = ref_for(path, (h, w))
        buckets.setdefault((h, w, rp is not None), []).append((path, rp))

    def metrics_fn(batch_u8: torch.Tensor) -> dict:
        x = batch_u8.to(torch.float32) / 255.0
        with torch.inference_mode():
            return calculate_metrics(x[:, 0], x[:, 1] if x.shape[1] == 2 else None)

    call = metrics_fn if mesh is None else shard_batch_fn(metrics_fn, mesh)
    rows_by_path: dict[str, dict] = {}
    for (_h, _w, has_ref), pairs in buckets.items():
        for i in range(0, len(pairs), batch_size):
            chunk = pairs[i : i + batch_size]
            batch = np.stack([
                np.stack([decode_image(p)] + ([decode_image(rp)] if has_ref else []), axis=0) for p, rp in chunk
            ])  # [N, 1|2, H, W, 3] u8
            batch, n = pad_for_mesh(batch, mesh)
            out = fetch(call(batch if mesh is not None else torch.from_numpy(batch).to(dev)), n)
            # Sorted keys: the JAX rows come out of a pytree map, which sorts them.
            out = {k: out[k] for k in sorted(out)}
            for j, (path, _rp) in enumerate(chunk):
                rows_by_path[path] = {"image": os.path.basename(path), **{k: float(v[j]) for k, v in out.items()}}

    rows = [rows_by_path[p] for p in files]
    keys = [k for k in NO_REF_KEYS + REF_KEYS if any(k in r for r in rows)]
    print(f"Evaluated {len(rows)} images:")
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        if vals:
            print(f"  {k}: mean {np.mean(vals):.4f}  min {np.min(vals):.4f}  max {np.max(vals):.4f}")

    if output_csv:
        os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
        with open(output_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["image"] + keys)
            writer.writeheader()
            for r in rows:
                writer.writerow({k: r.get(k, "") for k in ["image"] + keys})
        print(f"Wrote {output_csv}")
    return rows
