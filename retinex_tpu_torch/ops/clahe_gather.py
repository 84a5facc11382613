"""Lab-CLAHE on five CUDA kernels, with their plain PyTorch versions.

Counterpart of ``retinex_tpu/ops/clahe_gather.py``: its planar pipeline
(``clahe_rgb_u8_planar_gather5``, ``clahe_lab_rgb_gather``), which the net
route and single-image ``--classical_mode clahe`` run, and its NHWC u8 entry
(``clahe_rgb_u8_gather``), which directory batches in ``clahe`` mode run.
The kernels live in ``retinex_tpu_torch/csrc/clahe_lab.cu``:

- ``lab_fwd_u8`` (K1): planar u8 sRGB [B,3,H,W] -> planar u8 OpenCV Lab;
- ``lab_fwd_u8_nhwc`` (K8, forward half): u8 NHWC sRGB [B,H,W,3] -> the
  same planar Lab, the transpose folded into the kernel's reads;
- ``clahe_tables`` (K2): per-tile histograms of a u8 plane (the L plane of
  planar Lab, or a [B,H,W] luma plane for ``ops/clahe_luma.py``) with the
  within-cell ``hist_subsample`` decimation, OpenCV clip/redistribute, CDF
  and LUT, as u8 [B, tiles_y, tiles_x, 256]; each tile's rows are spread
  over several blocks (``tables_plan``);
- ``clahe_apply_u8`` (K3): 4-neighbour LUT blend on L, then Lab -> planar
  sRGB u8;
- ``clahe_apply_u8_nhwc`` (K8, apply half): the same, written as NHWC.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES`` counts
the kernel launches of each wrapper. The JAX package's 6D cell layout and
band pickers are TPU artifacts and are not carried over.
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
LAUNCHES = {
    "lab_fwd_u8": 0,
    "lab_fwd_u8_nhwc": 0,
    "clahe_tables": 0,
    "clahe_apply_u8": 0,
    "clahe_apply_u8_nhwc": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_planar_u8(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"{what}: expected uint8 [B, 3, H, W], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_nhwc_u8(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"{what}: expected uint8 [B, H, W, 3], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_cells(h: int, w: int, tiles_y: int, tiles_x: int) -> None:
    if not cell_divisible(h, w, tiles_y, tiles_x):
        raise ValueError(f"shape {(h, w)} is not a multiple of (2*tiles_y, 2*tiles_x) = {(2 * tiles_y, 2 * tiles_x)}")


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
    stream = _kernels.stream(rgb)
    out = torch.empty_like(rgb)
    tab = _degamma_table(str(rgb.device))
    b, _, h, w = rgb.shape
    _kernels.launch("clahe_lab_fwd_u8", rgb.data_ptr(), out.data_ptr(), tab.data_ptr(), b, h * w, stream)
    LAUNCHES["lab_fwd_u8"] += 1
    return out


def lab_fwd_u8_nhwc_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's forward half: K1's on the permuted batch."""
    return lab_fwd_u8_plain(rgb.permute(0, 3, 1, 2).contiguous())


def lab_fwd_u8_nhwc(rgb: torch.Tensor) -> torch.Tensor:
    """K8, forward half: u8 NHWC sRGB [B,H,W,3] -> planar u8 Lab [B,3,H,W]."""
    _check_nhwc_u8(rgb, "lab_fwd_u8_nhwc")
    if rgb.device.type == "cpu":
        return lab_fwd_u8_nhwc_plain(rgb)
    stream = _kernels.stream(rgb)
    b, h, w, _ = rgb.shape
    out = torch.empty((b, 3, h, w), dtype=torch.uint8, device=rgb.device)
    tab = _degamma_table(str(rgb.device))
    _kernels.launch("clahe_lab_fwd_u8_nhwc", rgb.data_ptr(), out.data_ptr(), tab.data_ptr(), b, h * w, stream)
    LAUNCHES["lab_fwd_u8_nhwc"] += 1
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


def _plane(src: torch.Tensor, what: str) -> tuple[torch.Tensor, int]:
    """The u8 plane K2 reads, and the stride between its images: the L
    plane of planar Lab [B,3,H,W] (stride 3*H*W) or a plane [B,H,W]
    (stride H*W)."""
    if src.ndim == 4:
        _check_planar_u8(src, what)
        return src[:, 0], 3 * src.shape[2] * src.shape[3]
    if src.dtype != torch.uint8 or src.ndim != 3 or not src.is_contiguous():
        raise ValueError(f"{what}: expected contiguous uint8 [B, 3, H, W] or [B, H, W], got {src.dtype} {tuple(src.shape)}")
    return src, src.shape[1] * src.shape[2]


def clahe_tables_plain(
    src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8, hist_subsample: int = 1
) -> torch.Tensor:
    """Plain version of K2: planar u8 Lab (its L plane) or a u8 plane
    [B,H,W] -> u8 LUTs [B, tiles_y, tiles_x, 256]."""
    plane, _ = _plane(src, "clahe_tables_plain")
    hist, area = _hist_from_cells(plane, tiles_y, tiles_x, hist_subsample)
    return _luts_from_hist(hist, clip_limit, area).to(torch.uint8)


# K2 spreads each tile's rows over this many blocks per SM in all.
K2_BLOCKS_PER_SM = 4


def tables_plan(
    h: int, tiles_y: int, tiles_x: int, hist_subsample: int, batch: int, n_sm: int = 132
) -> tuple[int, int]:
    """(strips per tile, sampled rows per strip) of K2's launch: a tile's
    sampled rows (``strip_rows``) cut into strips so that the grid holds
    about K2_BLOCKS_PER_SM blocks per SM, every strip at least one row."""
    hh = h // (2 * tiles_y)
    n_rows = 2 * (-(-hh // hist_subsample))
    want = -(-K2_BLOCKS_PER_SM * n_sm // (batch * tiles_y * tiles_x))
    rows = -(-n_rows // max(1, min(want, n_rows)))
    return -(-n_rows // rows), rows


def strip_rows(h: int, tiles_y: int, hist_subsample: int, strip: int, rows_per_strip: int) -> list[int]:
    """The tile rows that K2's block for `strip` reads, as the kernel walks
    them: sampled row j is tile row j*s in the first half-tile cell and
    hh + (j - per_cell)*s in the second (per_cell = ceil(hh / s))."""
    hh, s = h // (2 * tiles_y), hist_subsample
    per_cell = -(-hh // s)
    js = range(strip * rows_per_strip, min((strip + 1) * rows_per_strip, 2 * per_cell))
    return [j * s if j < per_cell else hh + (j - per_cell) * s for j in js]


def _load_width(plane: torch.Tensor, img_stride: int, w: int, tiles_x: int) -> int:
    """Bytes a K2 thread loads at once: 16, else 4, else 1, as the plane's
    address, the image stride, the row stride and the tile width allow."""
    for v in (16, 4):
        if plane.data_ptr() % v == 0 and img_stride % v == 0 and w % v == 0 and (w // tiles_x) % v == 0:
            return v
    return 1


def clahe_tables(
    src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8, hist_subsample: int = 1
) -> torch.Tensor:
    """K2: the CLAHE LUT of every tile, from the L plane of planar u8 Lab
    [B,3,H,W] or from a u8 plane [B,H,W]. On the card one launch: row
    strips of each tile (``tables_plan``), the last block of a tile
    building its table."""
    plane, img_stride = _plane(src, "clahe_tables")
    b, h, w = plane.shape
    _check_cells(h, w, tiles_y, tiles_x)
    clip, lut_scale = _table_params(h, w, tiles_y, tiles_x, clip_limit, hist_subsample)
    if src.device.type == "cpu":
        return clahe_tables_plain(src, clip_limit, tiles_y, tiles_x, hist_subsample)
    stream = _kernels.stream(src)
    out = torch.empty((b, tiles_y, tiles_x, HIST_SIZE), dtype=torch.uint8, device=src.device)
    if b == 0:
        return out
    n_sm = torch.cuda.get_device_properties(src.device).multi_processor_count
    strips, rows = tables_plan(h, tiles_y, tiles_x, hist_subsample, b, n_sm)
    # The tiles' int32 histograms, then their arrival counters.
    scratch = torch.zeros(b * tiles_y * tiles_x * (HIST_SIZE + 1), dtype=torch.int32, device=src.device)
    _kernels.launch(
        "clahe_tables", src.data_ptr(), out.data_ptr(), scratch.data_ptr(), img_stride, b, h, w, tiles_y, tiles_x,
        hist_subsample, clip, float(lut_scale), strips, rows, _load_width(plane, img_stride, w, tiles_x), stream,
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


def _check_luts(luts: torch.Tensor, b: int, h: int, w: int, device: torch.device, what: str) -> tuple[int, int]:
    """Validate u8 LUTs [b, ty, tx, 256] for an h x w frame; return (ty, tx)."""
    if luts.dtype != torch.uint8 or luts.ndim != 4 or luts.shape[0] != b or luts.shape[3] != HIST_SIZE:
        raise ValueError(f"{what}: expected uint8 LUTs [{b}, ty, tx, 256], got {luts.dtype} {tuple(luts.shape)}")
    if not luts.is_contiguous() or luts.device != device:
        raise ValueError(f"{what}: LUTs must be contiguous and on the image's device")
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    _check_cells(h, w, tiles_y, tiles_x)
    if device.type != "cpu" and 2 * tiles_x * HIST_SIZE > 48 * 1024:
        raise ValueError(f"{what}: tiles_x={tiles_x} needs more than 48 KB of shared memory")
    return tiles_y, tiles_x


def clahe_apply_u8(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K3: planar u8 Lab + u8 LUTs [B, tiles_y, tiles_x, 256] -> planar u8 sRGB."""
    _check_planar_u8(lab, "clahe_apply_u8")
    b, _, h, w = lab.shape
    tiles_y, tiles_x = _check_luts(luts, b, h, w, lab.device, "clahe_apply_u8")
    if lab.device.type == "cpu":
        return clahe_apply_u8_plain(lab, luts)
    stream = _kernels.stream(lab)
    out = torch.empty_like(lab)
    _kernels.launch(
        "clahe_apply_u8", lab.data_ptr(), luts.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x, stream
    )
    LAUNCHES["clahe_apply_u8"] += 1
    return out


def clahe_apply_u8_nhwc_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's apply half: K3's, permuted to NHWC."""
    return clahe_apply_u8_plain(lab, luts).permute(0, 2, 3, 1).contiguous()


def clahe_apply_u8_nhwc(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K8, apply half: planar u8 Lab + u8 LUTs -> u8 NHWC sRGB [B,H,W,3]."""
    _check_planar_u8(lab, "clahe_apply_u8_nhwc")
    b, _, h, w = lab.shape
    tiles_y, tiles_x = _check_luts(luts, b, h, w, lab.device, "clahe_apply_u8_nhwc")
    if lab.device.type == "cpu":
        return clahe_apply_u8_nhwc_plain(lab, luts)
    stream = _kernels.stream(lab)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=lab.device)
    _kernels.launch(
        "clahe_apply_u8_nhwc", lab.data_ptr(), luts.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x, stream
    )
    LAUNCHES["clahe_apply_u8_nhwc"] += 1
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


def clahe_rgb_u8_gather(
    x_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """uint8 NHWC (or HWC) Lab-CLAHE -> the same shape: K8 (forward) -> K2
    -> K8 (apply), the directory batches' ``clahe`` route.

    H and W must be multiples of 2*tiles. Unlike the JAX package's batched
    accelerator route, ``hist_subsample`` is honoured here as on every other
    route."""
    squeeze = x_u8.ndim == 3
    if squeeze:
        x_u8 = x_u8[None]
    _check_cells(x_u8.shape[1], x_u8.shape[2], tiles_y, tiles_x)
    lab = lab_fwd_u8_nhwc(x_u8.contiguous())
    luts = clahe_tables(lab, clip_limit, tiles_y, tiles_x, hist_subsample)
    out = clahe_apply_u8_nhwc(lab, luts)
    return out[0] if squeeze else out


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
