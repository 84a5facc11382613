"""Batched augmentation on the device, split into draw and apply.

Counterpart of ``retinex_tpu/data/augment.py::augment_batch``, which draws
its per-sample gates and magnitudes from one JAX key and applies them in one
jitted function. Here ``draw_basic`` / ``draw_advanced`` take them from a
``torch.Generator`` (the same distributions; not JAX's numbers) and
``apply_augment`` applies any draws, the JAX package's included, so a test
can feed JAX's own draws and compare.

Basic: horizontal and vertical flips, each with p 0.5, and on a square
canvas a rotation by 1-3 quarter turns with p 0.5. Advanced: gamma 0.6-1.8,
contrast 0.8-1.2 around the per-sample mean, brightness +-0.1, Gaussian noise
of sigma 0.01-0.03 with p 0.7, saturation 0.8-1.2 by a Rec.601 gray mix and
the reference's "hue shift" (a +-0.05 shift of all channels, kept); each
gate is an independent draw from its magnitude.

A uint8 batch becomes float as ``u8 * f32(1/255)``: the jitted JAX function
compiles its ``u8 / 255.0`` to that product, which rounds 126 of the 256
bytes otherwise than IEEE division (``ops/colorspace.ieee_div``).
"""

from __future__ import annotations

import numpy as np
import torch

from retinex_tpu_torch.ops.colorspace import rgb_to_luma
from retinex_tpu_torch.parallel.distributed import data_shard

RECIP_255 = float(np.float32(1.0) / np.float32(255.0))

ADVANCED_RANGES = {  # magnitude: (low, high); gate: probability
    "gamma": (0.6, 1.8), "contrast": (0.8, 1.2), "brightness": (-0.1, 0.1), "sigma": (0.01, 0.03),
    "saturation": (0.8, 1.2), "hue": (-0.05, 0.05),
}
ADVANCED_GATES = {"g_on": 0.5, "c_on": 0.5, "br_on": 0.5, "n_on": 0.7, "s_on": 0.5, "h_on": 0.5}


def _uniform(b: int, gen, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand((b, 1, 1, 1), generator=gen, device=device)
    return u * (hi - lo) + lo


def draw_basic(b: int, gen: torch.Generator | None = None, device=None) -> dict[str, torch.Tensor]:
    """Per-sample flips and rotation: hflip, vflip, rot [B] bool and k [B]
    int in 1..3 (quarter turns)."""
    return {
        "hflip": _uniform(b, gen, device).view(b) < 0.5,
        "vflip": _uniform(b, gen, device).view(b) < 0.5,
        "rot": _uniform(b, gen, device).view(b) < 0.5,
        "k": torch.randint(1, 4, (b,), generator=gen, device=device),
    }


def draw_advanced(shape, gen: torch.Generator | None = None, device=None) -> dict[str, torch.Tensor]:
    """Gates (f32 0/1, [B,1,1,1]), magnitudes ([B,1,1,1]) and the unit
    normal noise of the batch's `shape` (scaled by sigma in the apply)."""
    b = shape[0]
    out = {k: (_uniform(b, gen, device) < p).float() for k, p in ADVANCED_GATES.items()}
    out.update({k: _uniform(b, gen, device, lo, hi) for k, (lo, hi) in ADVANCED_RANGES.items()})
    out["noise"] = torch.randn(tuple(shape), generator=gen, device=device)
    return out


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def apply_augment(batch: torch.Tensor, basic: dict | None = None, advanced: dict | None = None) -> torch.Tensor:
    """Augment an NHWC batch (uint8 or float [0,1]) with the given draws;
    returns float [0,1]. Either dict may be None (that half is skipped)."""
    x = batch.float() * RECIP_255 if batch.dtype == torch.uint8 else batch
    if basic is not None:
        sel = lambda m: m.view(-1, 1, 1, 1)  # noqa: E731
        x = torch.where(sel(basic["hflip"]), torch.flip(x, dims=(2,)), x)
        x = torch.where(sel(basic["vflip"]), torch.flip(x, dims=(1,)), x)
        if x.shape[1] == x.shape[2]:  # rot90 needs a square canvas
            k = sel(basic["k"])
            r1, r2, r3 = (torch.rot90(x, n, dims=(1, 2)) for n in (1, 2, 3))
            rotated = torch.where(k == 1, r1, torch.where(k == 2, r2, r3))
            x = torch.where(sel(basic["rot"]), rotated, x)
    if advanced is not None:
        p = advanced
        x_g = torch.pow(torch.clamp(x, min=1e-8), p["gamma"])
        x = p["g_on"] * x_g + (1.0 - p["g_on"]) * x
        mean = x.mean(dim=(1, 2), keepdim=True)
        x_c = _clip01((x - mean) * p["contrast"] + mean)
        x = p["c_on"] * x_c + (1.0 - p["c_on"]) * x
        x = _clip01(x + p["br_on"] * p["brightness"])
        x = _clip01(x + p["n_on"] * (p["noise"] * p["sigma"]))
        gray = rgb_to_luma(x)
        x_s = _clip01(gray + p["saturation"] * (x - gray))
        x = p["s_on"] * x_s + (1.0 - p["s_on"]) * x
        x = _clip01(x + p["h_on"] * p["hue"])
    return x


def augment_batch(
    batch: torch.Tensor, gen: torch.Generator | None = None, basic: bool = True, advanced: bool = False
) -> torch.Tensor:
    """Draw from `gen` and apply, on the batch's device. Across ranks
    (``parallel/distributed.py``) the batch is this rank's rows of the
    global batch: every rank draws for the global batch and keeps its rows."""
    b, dev = batch.shape[0], batch.device
    rank, world = data_shard()
    draws = [
        draw_basic(b * world, gen, dev) if basic else None,
        draw_advanced((b * world, *batch.shape[1:]), gen, dev) if advanced else None,
    ]
    if world > 1:
        draws = [None if d is None else {k: v[rank * b : (rank + 1) * b] for k, v in d.items()} for d in draws]
    return apply_augment(batch, *draws)
