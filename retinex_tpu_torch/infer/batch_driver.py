"""Bucketed batches for directory-scale enhance.

Counterpart of ``retinex_tpu/infer/batch_driver.py`` on one device:

- files are bucketed by letterboxed canvas (header-only planning, no pixel
  decode), so every chunk of a bucket has one shape;
- a chunk decodes to a uint8 NHWC batch (PIL, as the JAX package's fallback
  decodes) and goes to the device as uint8; the results come back as uint8;
- the loop is software-pipelined: the device's work on chunk N is queued
  (CUDA launches return at once), the host decodes chunk N+1 meanwhile,
  then drains chunk N before it queues N+1 (the drain's copy to the host is
  the synchronisation point; queued after N+1 it would wait for N+1 too).

Batches across several devices (the JAX package's ``shard_map`` over a data
mesh) land with ROADMAP Queue 1 item 8; ``maybe_mesh`` raises for them.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.data.dataset import decode_image
from retinex_tpu_torch.ops.letterbox import letterbox_np, plan_letterbox


def plan_canvas(path: str, max_size: int | None):
    """Letterbox canvas for one file without decoding pixels (header only).
    With no max_size the target is the image's longer side."""
    with Image.open(path) as im:
        w, h = im.size
    target = max_size if max_size is not None else max(h, w)
    return target, plan_letterbox(h, w, target, auto=True, scaleup=False)


def bucket_by_canvas(files: list[str], max_size: int | None) -> dict[tuple[int, int, int], list[str]]:
    """Group files by (letterbox target, out_h, out_w): one shape each."""
    buckets: dict[tuple[int, int, int], list[str]] = {}
    for path in files:
        target, plan = plan_canvas(path, max_size)
        buckets.setdefault((target, plan.out_h, plan.out_w), []).append(path)
    return buckets


def decode_bucket(paths: list[str], target: int) -> np.ndarray:
    """Decode + letterbox a same-canvas chunk to a uint8 NHWC batch (PIL)."""
    imgs = []
    for p in paths:
        rgb = decode_image(p)
        imgs.append(letterbox_np(rgb, plan_letterbox(rgb.shape[0], rgb.shape[1], target, auto=True, scaleup=False)))
    return np.stack(imgs, axis=0)


def run_bucketed(
    files: list[str],
    *,
    max_size: int | None,
    batch_size: int,
    fn: Callable[[torch.Tensor], tuple],
    drain_cb: Callable[[list[str], np.ndarray, object], None] | None,
    device: torch.device,
) -> list[float]:
    """The pipelined dispatch loop of directory enhance.

    fn: a uint8 NHWC batch on `device` -> a tuple of tensors (or None),
    for every canvas; drain_cb(paths, batch_u8,
    outputs_np) consumes the results on the host. Returns per-image
    device + transfer seconds (the decode of the next chunk, which overlaps
    the device's work, subtracted)."""
    buckets = bucket_by_canvas(files, max_size)
    print(f"{len(buckets)} shape bucket(s): " + ", ".join(f"{h}x{w} x{len(v)}" for (_t, h, w), v in buckets.items()))

    timings: list[float] = []
    decode_s = 0.0
    processed = 0

    def drain(pending, overlapped: float = 0.0):
        nonlocal processed
        chunk, out_h, out_w, batch_u8, outputs, t1 = pending
        out_np = tuple(None if o is None else o.cpu().numpy() for o in outputs)  # waits for the device
        t2 = time.time()
        if drain_cb is not None:
            drain_cb(chunk, batch_u8, out_np)
        chunk_s = max(t2 - t1 - overlapped, 0.0)
        timings.extend([chunk_s / len(chunk)] * len(chunk))
        processed += len(chunk)
        print(f"[{processed}/{len(files)}] {out_h}x{out_w} chunk of {len(chunk)}: enhance+io {chunk_s:.3f}s")

    pending = None
    for key, paths in buckets.items():
        target, out_h, out_w = key
        for i in range(0, len(paths), batch_size):
            chunk = paths[i : i + batch_size]
            t0 = time.time()
            batch_u8 = decode_bucket(chunk, target)
            t1 = time.time()
            decode_s += t1 - t0
            if pending is not None:  # the device ran chunk N while the host decoded N+1
                drain(pending, overlapped=t1 - t0)
            t_dispatch = time.time()
            outputs = fn(torch.from_numpy(batch_u8).to(device))  # queued on the device
            pending = (chunk, out_h, out_w, batch_u8, outputs, t_dispatch)
    if pending is not None:
        drain(pending)

    total = sum(timings)
    print(
        f"Processed {len(files)} images: enhance {total:.2f}s "
        f"({len(files) / max(total, 1e-9):.1f} img/s), decode {decode_s:.2f}s"
    )
    return timings


def maybe_mesh(n_devices: int | None = None):
    """None: the port's batches run on one device. ``n_devices > 1`` (the
    JAX package's data mesh) raises until ROADMAP Queue 1 item 8 lands."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"--n_devices {n_devices}: batches across several GPUs land in ROADMAP Queue 1 item 8"
        )
    return None
