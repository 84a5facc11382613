"""Seeded photos made from the committed low-light material.

The material is the 24 ``data/convergence/lowlight_*.png`` (640x640) of the
repository; their joint SHA-256 is checked, so a change to them stops the
benchmark instead of changing its traffic. Each photo draws from the seed
its source, a crop of the source's aspect-matched window, a horizontal flip
and an exposure gain, and is resized to the cell's size and written as a
JPEG (quality 92, 4:2:0) or a PNG. Same seed, same files.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[2]
MATERIAL = "data/convergence"
MATERIAL_FILES = 24
MATERIAL_SHA256 = "08208786dca549efeb6d5136895d8fae6b7ae392f03e91e75fcd32908766226b"


def material() -> list[np.ndarray]:
    """The 24 source photos as uint8 HWC arrays, after checking their digest."""
    paths = sorted((ROOT / MATERIAL).glob("lowlight_*.png"))
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.read_bytes())
    if len(paths) != MATERIAL_FILES or digest.hexdigest() != MATERIAL_SHA256:
        raise RuntimeError(f"{MATERIAL}: the photo material is not the benchmark's ({len(paths)} files)")
    out = []
    for p in paths:
        with Image.open(p) as im:
            out.append(np.asarray(im.convert("RGB")))
    return out


def draw_plans(seed: int, n: int, width: int, height: int, n_sources: int = MATERIAL_FILES) -> list[dict]:
    """n photo plans drawn from the seed: source, crop, flip, gain."""
    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n):
        src = int(rng.integers(n_sources))
        frac = float(rng.uniform(0.7, 1.0))
        gain = float(rng.uniform(0.7, 1.3))
        flip = bool(rng.integers(2))
        ox, oy = float(rng.uniform()), float(rng.uniform())
        plans.append({"src": src, "frac": frac, "gain": gain, "flip": flip, "ox": ox, "oy": oy,
                      "width": width, "height": height})
    return plans


def render(src: np.ndarray, plan: dict) -> np.ndarray:
    """One plan applied to its source: uint8 [height, width, 3]."""
    sh, sw = src.shape[:2]
    aspect = plan["width"] / plan["height"]
    cw = max(8, int(round(sw * plan["frac"])))
    ch = int(round(cw / aspect))
    if ch > sh:
        ch = max(8, int(round(sh * plan["frac"])))
        cw = min(sw, int(round(ch * aspect)))
    x0 = int(plan["ox"] * (sw - cw))
    y0 = int(plan["oy"] * (sh - ch))
    crop = src[y0 : y0 + ch, x0 : x0 + cw].astype(np.float32) * plan["gain"]
    crop = np.clip(np.round(crop), 0, 255).astype(np.uint8)
    if plan["flip"]:
        crop = crop[:, ::-1]
    img = Image.fromarray(np.ascontiguousarray(crop)).resize((plan["width"], plan["height"]), Image.BICUBIC)
    return np.asarray(img)


def write(directory: str, seed: int, n: int, width: int, height: int, fmt: str = "jpeg",
          threads: int = 8) -> list[str]:
    """Write n seeded photos into `directory` (JPEG quality 92, 4:2:0, or
    PNG); returns their paths in name order."""
    os.makedirs(directory, exist_ok=True)
    sources = material()
    plans = draw_plans(seed, n, width, height, len(sources))
    ext = "jpg" if fmt == "jpeg" else "png"
    paths = [os.path.join(directory, f"photo_{i:03d}.{ext}") for i in range(n)]

    def one(i: int) -> None:
        img = Image.fromarray(render(sources[plans[i]["src"]], plans[i]))
        if fmt == "jpeg":
            img.save(paths[i], "JPEG", quality=92, subsampling="4:2:0")
        else:
            img.save(paths[i], "PNG", compress_level=1)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for f in [pool.submit(one, i) for i in range(n)]:
            f.result()
    return paths
