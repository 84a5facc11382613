"""Lab-CLAHE on three CUDA kernels, with their plain PyTorch versions.

Counterpart of ``retinex_tpu/ops/clahe_gather.py``'s planar pipeline
(``clahe_rgb_u8_planar_gather5`` and ``clahe_lab_rgb_gather``). The kernels
live in ``retinex_tpu_torch/csrc/clahe_lab.cu``:

- ``lab_fwd_u8`` (K1): planar u8 sRGB [B,3,H,W] -> planar u8 OpenCV Lab;
- ``clahe_tables`` (K2): per-tile histograms of L (with the within-cell
  ``hist_subsample`` decimation), OpenCV clip/redistribute, CDF and LUT,
  as u8 [B, tiles_y, tiles_x, 256];
- ``clahe_apply_u8`` (K3): 4-neighbour LUT blend on L, then Lab -> sRGB u8.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from retinex_tpu_torch.ops import _kernels
from retinex_tpu_torch.ops.clahe import HIST_SIZE, _luts_from_hist, cell_divisible
from retinex_tpu_torch.ops.clahe_fast import _hist_from_cells, apply_from_cells
from retinex_tpu_torch.ops.colorspace import (
    lab8_to_linear_rgb,
    linear_rgb_to_lab8,
    linear_to_srgb,
    srgb_to_linear,
)

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"lab_fwd_u8": 0, "clahe_tables": 0, "clahe_apply_u8": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_planar_u8(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"{what}: expected uint8 [B, 3, H, W], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_cells(h: int, w: int, tiles_y: int, tiles_x: int) -> None:
    if not cell_divisible(h, w, tiles_y, tiles_x):
        raise ValueError(f"shape {(h, w)} is not a multiple of (2*tiles_y, 2*tiles_x) = {(2 * tiles_y, 2 * tiles_x)}")


def _stream(x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel path takes CUDA tensors, the plain path CPU tensors")
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _degamma_table(device: str) -> torch.Tensor:
    """f32 [256]: srgb_to_linear(v / 255) for every u8 value v."""
    v = torch.arange(HIST_SIZE, dtype=torch.float32) / 255.0
    return srgb_to_linear(v).to(device)


# ---------------------------------------------------------------- K1


def lab_fwd_u8_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: planar u8 sRGB -> planar u8 8-bit Lab."""
    tab = _degamma_table(str(rgb.device))
    r, g, b = (tab[rgb[:, c].long()] for c in range(3))
    lab = linear_rgb_to_lab8(r, g, b)
    return torch.stack([torch.clamp(torch.round(ch), 0, 255) for ch in lab], dim=1).to(torch.uint8)


def lab_fwd_u8(rgb: torch.Tensor) -> torch.Tensor:
    """K1: planar u8 sRGB [B,3,H,W] -> planar u8 OpenCV 8-bit Lab."""
    _check_planar_u8(rgb, "lab_fwd_u8")
    if rgb.device.type == "cpu":
        return lab_fwd_u8_plain(rgb)
    stream = _stream(rgb)
    out = torch.empty_like(rgb)
    tab = _degamma_table(str(rgb.device))
    b, _, h, w = rgb.shape
    _kernels.launch("clahe_lab_fwd_u8", rgb.data_ptr(), out.data_ptr(), tab.data_ptr(), b, h * w, stream)
    LAUNCHES["lab_fwd_u8"] += 1
    return out


# ---------------------------------------------------------------- K2


def _table_params(h: int, w: int, tiles_y: int, tiles_x: int, clip_limit: float, s: int):
    """(clip, f32 LUT scale) of the tables built from the within-cell s x s
    decimation, whose sampled tile area is 4 * ceil(hh/s) * ceil(hw/s)."""
    if s < 1:
        raise ValueError(f"hist_subsample must be >= 1, got {s}")
    hh, hw = h // (2 * tiles_y), w // (2 * tiles_x)
    area = 4 * (-(-hh // s)) * (-(-hw // s))
    clip = max(int(clip_limit * area / HIST_SIZE), 1)
    return clip, np.float32(float(HIST_SIZE - 1) / float(area))


def clahe_tables_plain(
    lab: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8, hist_subsample: int = 1
) -> torch.Tensor:
    """Plain version of K2: planar u8 Lab -> u8 LUTs [B, tiles_y, tiles_x, 256]."""
    hist, area = _hist_from_cells(lab[:, 0], tiles_y, tiles_x, hist_subsample)
    return _luts_from_hist(hist, clip_limit, area).to(torch.uint8)


def clahe_tables(
    lab: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8, hist_subsample: int = 1
) -> torch.Tensor:
    """K2: the CLAHE LUT of every tile, from the L plane of planar u8 Lab."""
    _check_planar_u8(lab, "clahe_tables")
    b, _, h, w = lab.shape
    _check_cells(h, w, tiles_y, tiles_x)
    clip, lut_scale = _table_params(h, w, tiles_y, tiles_x, clip_limit, hist_subsample)
    if lab.device.type == "cpu":
        return clahe_tables_plain(lab, clip_limit, tiles_y, tiles_x, hist_subsample)
    stream = _stream(lab)
    out = torch.empty((b, tiles_y, tiles_x, HIST_SIZE), dtype=torch.uint8, device=lab.device)
    _kernels.launch(
        "clahe_tables", lab.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x,
        hist_subsample, clip, float(lut_scale), stream,
    )
    LAUNCHES["clahe_tables"] += 1
    return out


# ---------------------------------------------------------------- K3


def clahe_apply_u8_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: LUT blend on L, a/b through, Lab -> planar u8 sRGB."""
    L2 = apply_from_cells(lab[:, 0], luts).to(torch.float32)
    rgb = lab8_to_linear_rgb(L2, lab[:, 1].float(), lab[:, 2].float())
    return torch.stack(
        [torch.round(torch.clamp(linear_to_srgb(ch), 0.0, 1.0) * 255.0) for ch in rgb], dim=1
    ).to(torch.uint8)


def clahe_apply_u8(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K3: planar u8 Lab + u8 LUTs [B, tiles_y, tiles_x, 256] -> planar u8 sRGB."""
    _check_planar_u8(lab, "clahe_apply_u8")
    b, _, h, w = lab.shape
    if luts.dtype != torch.uint8 or luts.ndim != 4 or luts.shape[0] != b or luts.shape[3] != HIST_SIZE:
        raise ValueError(f"clahe_apply_u8: expected uint8 LUTs [{b}, ty, tx, 256], got {luts.dtype} {tuple(luts.shape)}")
    if not luts.is_contiguous() or luts.device != lab.device:
        raise ValueError("clahe_apply_u8: LUTs must be contiguous and on the Lab tensor's device")
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    _check_cells(h, w, tiles_y, tiles_x)
    if lab.device.type == "cpu":
        return clahe_apply_u8_plain(lab, luts)
    if 2 * tiles_x * HIST_SIZE > 48 * 1024:
        raise ValueError(f"clahe_apply_u8: tiles_x={tiles_x} needs more than 48 KB of shared memory")
    stream = _stream(lab)
    out = torch.empty_like(lab)
    _kernels.launch(
        "clahe_apply_u8", lab.data_ptr(), luts.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x, stream
    )
    LAUNCHES["clahe_apply_u8"] += 1
    return out


# ---------------------------------------------------------------- pipeline


def clahe_rgb_u8_planar_gather(
    xp_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """Planar uint8 Lab-CLAHE: [B, 3, H, W] -> [B, 3, H, W], K1 -> K2 -> K3.

    H and W must be multiples of 2*tiles (any such size: the TPU's cell
    width limit does not apply)."""
    _check_cells(xp_u8.shape[2], xp_u8.shape[3], tiles_y, tiles_x)
    lab = lab_fwd_u8(xp_u8)
    luts = clahe_tables(lab, clip_limit, tiles_y, tiles_x, hist_subsample)
    return clahe_apply_u8(lab, luts)


def clahe_lab_rgb_gather(
    x: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """Float wrapper over the planar u8 pipeline. x: float [0,1] NHWC/HWC."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    xp = x.permute(0, 3, 1, 2)
    xq = torch.clamp(torch.round(torch.clamp(xp, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8).contiguous()
    outp = clahe_rgb_u8_planar_gather(
        xq, clip_limit=clip_limit, tiles_x=tiles_x, tiles_y=tiles_y, hist_subsample=hist_subsample
    )
    out = (outp.to(torch.float32) / 255.0).permute(0, 2, 3, 1)
    return out[0] if squeeze else out
