"""Bucketed batches for directory-scale enhance.

Counterpart of ``retinex_tpu/infer/batch_driver.py`` on one device:

- files are bucketed by letterboxed canvas (header-only planning, no pixel
  decode), so every chunk of a bucket has one shape;
- a chunk decodes to a uint8 NHWC batch on a pool of ``num_workers``
  threads (``data/native_loader.decode_letterbox_batch_canvas``, where the
  JAX package calls its native loader) and goes to the device as uint8; the
  results come back as uint8;
- the loop is software-pipelined: the device's work on chunk N is queued
  (CUDA launches return at once), the host decodes chunk N+1 meanwhile,
  then drains chunk N before it queues N+1 (the drain's copy to the host is
  the synchronisation point; queued after N+1 it would wait for N+1 too).

Over a data mesh (``--n_devices``, ``parallel/mesh.py``) each chunk is
padded to a multiple of the mesh, split along the batch, and ``fn`` runs
whole on each device's slice with that device's copy of the weights, as the
JAX package's ``shard_map`` runs it: no collective, since nothing crosses
an image. Every slice's launches are queued before the first copy back, so
the cards run at once; the slices are joined and the padding dropped on the
host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch
from PIL import Image

from retinex_tpu_torch.data.native_loader import decode_letterbox_batch_canvas
from retinex_tpu_torch.ops.letterbox import plan_letterbox
from retinex_tpu_torch.parallel.mesh import Mesh, create_mesh, pad_to_multiple, shard_batch


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


def decode_bucket(paths: list[str], target: int, out_h: int, out_w: int, num_workers: int = 8) -> np.ndarray:
    """Decode + letterbox a same-canvas chunk to a uint8 NHWC batch
    [N, out_h, out_w, 3] on `num_workers` threads."""
    return decode_letterbox_batch_canvas(
        paths, target, out_h, out_w, auto_pad=True, scaleup=False, num_threads=num_workers
    )


def run_bucketed(
    files: list[str],
    *,
    max_size: int | None,
    batch_size: int,
    fn: Callable[[torch.Tensor], tuple],
    drain_cb: Callable[[list[str], np.ndarray, object], None] | None,
    device: torch.device,
    mesh: Mesh | None = None,
    num_workers: int = 8,
) -> list[float]:
    """The pipelined dispatch loop of directory enhance, each chunk decoded
    on `num_workers` threads.

    fn: a uint8 NHWC batch on `device` -> a tuple of tensors (or None),
    for every canvas; with `mesh`, each chunk runs through
    ``shard_batch_fn(fn, mesh)`` instead. drain_cb(paths, batch_u8,
    outputs_np) consumes the results on the host. Returns per-image
    device + transfer seconds (the decode of the next chunk, which overlaps
    the device's work, subtracted)."""
    sharded = None if mesh is None else shard_batch_fn(fn, mesh)
    buckets = bucket_by_canvas(files, max_size)
    print(f"{len(buckets)} shape bucket(s): " + ", ".join(f"{h}x{w} x{len(v)}" for (_t, h, w), v in buckets.items()))

    timings: list[float] = []
    decode_s = 0.0
    processed = 0

    def drain(pending, overlapped: float = 0.0):
        nonlocal processed
        chunk, out_h, out_w, batch_u8, outputs, t1 = pending
        out_np = fetch(outputs, len(chunk))  # waits for the device
        t2 = time.time()
        if drain_cb is not None:
            drain_cb(chunk, batch_u8[: len(chunk)], out_np)
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
            batch_u8, _n = pad_for_mesh(decode_bucket(chunk, target, out_h, out_w, num_workers), mesh)
            t1 = time.time()
            decode_s += t1 - t0
            if pending is not None:  # the device ran chunk N while the host decoded N+1
                drain(pending, overlapped=t1 - t0)
            t_dispatch = time.time()
            # queued on the device(s)
            outputs = fn(torch.from_numpy(batch_u8).to(device)) if sharded is None else sharded(batch_u8)
            pending = (chunk, out_h, out_w, batch_u8, outputs, t_dispatch)
    if pending is not None:
        drain(pending)

    total = sum(timings)
    print(
        f"Processed {len(files)} images: enhance {total:.2f}s "
        f"({len(files) / max(total, 1e-9):.1f} img/s), decode {decode_s:.2f}s"
    )
    return timings


class Sharded(list):
    """The outputs of ``shard_batch_fn``: one per mesh slice, in order."""


def shard_batch_fn(fn: Callable, mesh: Mesh) -> Callable:
    """A host batch (its size a multiple of the mesh's, ``pad_for_mesh``)
    -> ``Sharded`` outputs: the batch split along dim 0 over the mesh, each
    slice copied to its device first, then `fn` run whole on each slice with
    that device current (the kernels launch on the current card), so every
    slice's work is queued before any result is copied back. `fn` must take
    and return the batch along dim 0 (outputs: tensors, None, or tuples and
    dicts of them); ``fetch`` joins the slices on the host."""

    def run(batch) -> Sharded:
        parts = shard_batch(batch, mesh)
        outs = Sharded()
        for part, dev in zip(parts, mesh.devices):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                outs.append(fn(part))
        return outs

    return run


def _to_host(out):
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out.cpu().numpy()


def _join(parts):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_join([p[i] for p in parts]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts]) for k in first}
    return np.concatenate(parts, axis=0)


def _head(out, n: int):
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(_head(o, n) for o in out)
    if isinstance(out, dict):
        return {k: _head(v, n) for k, v in out.items()}
    return out[:n]


def fetch(outputs, n: int):
    """Device outputs (or ``Sharded`` ones) as numpy on the host, joined
    along dim 0 and cut to their first `n` rows (the mesh's padding
    dropped)."""
    if isinstance(outputs, Sharded):
        return _head(_join([_to_host(o) for o in outputs]), n)
    return _head(_to_host(outputs), n)


def pad_for_mesh(batch: np.ndarray, mesh: Mesh | None) -> tuple[np.ndarray, int]:
    """Pad the chunk's batch axis to a multiple of the mesh size."""
    if mesh is None:
        return batch, batch.shape[0]
    return pad_to_multiple(batch, mesh.size)


def maybe_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh | None:
    """A data mesh over `n_devices` devices (``None``: every visible card,
    or one CPU shard with `device` "cpu"), or None where that is one device,
    so the one-device paths stay exactly as they are. Raises where more
    cards are asked for than are visible."""
    mesh = create_mesh(n_devices, device)
    return None if mesh.size <= 1 else mesh
