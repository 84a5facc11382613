"""Luma-gain CLAHE (the ``clahe_luma`` mode) on CUDA kernels, with plain versions.

Counterpart of ``retinex_tpu/ops/clahe_luma.py``, with the same names. The
algorithm is an extra mode of the JAX package, not reference behaviour:

- y = round(0.299 R + 0.587 G + 0.114 B) on the gamma-encoded u8 values;
- CLAHE on y with the OpenCV tile-LUT build of the Lab path (K2, run here on
  the luma plane) and the same bilinear four-neighbour blend -> y_eq;
- gain = (y_eq + 1) / (y + 1), out_c = round(clip(rgb_c * gain, 0, 255)).

The kernels live in ``retinex_tpu_torch/csrc/clahe_luma.cu``:

- ``clahe_luma_apply_u8`` (K7): u8 RGB, planar [B,3,H,W] or NHWC
  [B,H,W,3] (a layout template of one kernel, the transpose folded into its
  indexing), + luma [B,H,W] + K2's u8 LUTs [B,ty,tx,256] -> u8 RGB in the
  same layout;
- ``clahe_luma_apply_u8_fused`` (K9): the same kernel on planar RGB,
  templated on recomputing y from the RGB it already loads; no luma operand.

Both read the frame's blend geometry and the gain's 256 reciprocals from
``luma_geometry`` and give their plain versions' bytes exactly. K7 (and
its plain version) also takes a slab of whole cell rows of a frame with the
frame's LUTs (``row0``, ``cell_rows``: ``clahe_fast.slab_cells``), as the
spatially sharded CLAHE runs it (``parallel/spatial.py``).

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES`` counts
the kernel launches of each wrapper. Cell-divisible shapes run the kernels;
other shapes run the plain ``clahe_luma_rgb_u8_xla`` on either device, as
the JAX package routes them.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from retinex_tpu_torch.ops import _kernels
from retinex_tpu_torch.ops.clahe import cell_divisible
from retinex_tpu_torch.ops.clahe_fast import _cell_maps, apply_from_cells, clahe_u8_fast, slab_cells
from retinex_tpu_torch.ops.clahe_gather import (
    _check_cells,
    _check_luts,
    _check_nhwc_u8,
    _check_planar_u8,
    clahe_tables,
)
from retinex_tpu_torch.ops.colorspace import ieee_div

# BT.601 weights, as the f32 values of the doubles the JAX package writes.
_LUMA_R, _LUMA_G, _LUMA_B = (float(np.float32(c)) for c in (0.299, 0.587, 0.114))

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"clahe_luma_apply_u8": 0, "clahe_luma_apply_u8_fused": 0}
# Of those, K7's launches on a slab that starts below the frame's first cell
# row (row0 > 0), as the spatially sharded CLAHE launches it.
SLAB_LAUNCHES = {"clahe_luma_apply_u8": 0}

log = logging.getLogger(__name__)


def reset_launches() -> None:
    for counts in (LAUNCHES, SLAB_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _luma_f32(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0.299 r + 0.587 g + 0.114 b on u8-valued f32 channels, contracted as
    the JAX package's compiled CPU program contracts it:
    fma(0.114, b, fma(0.299, r, 0.587 * g)). For these operands the float64
    products and sums are exact, so one rounding to f32 is each FMA's."""
    inner = (r.double() * _LUMA_R + (g * _LUMA_G).double()).float()
    return (b.double() * _LUMA_B + inner.double()).float()


def _luma_u8(x_u8: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """u8 RGB with its channels on `dim` (planar [b, 3, H, W], or NHWC with
    dim=3) -> [b, H, W] u8 luma (plain torch, as XLA computes it in the JAX
    package)."""
    r, g, b = (c.float() for c in x_u8.unbind(dim))
    return torch.clamp(torch.round(_luma_f32(r, g, b)), 0.0, 255.0).to(torch.uint8)


def _gain_u8(xp_u8: torch.Tensor, y: torch.Tensor, y_eq: torch.Tensor) -> torch.Tensor:
    """round(clip(rgb * (y_eq + 1) / (y + 1), 0, 255)) as planar u8."""
    gain = (y_eq.float() + 1.0) / (y.float() + 1.0)
    return torch.round(torch.clamp(xp_u8.float() * gain[:, None], 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------- K7, K9


def _is_nhwc(x_u8: torch.Tensor) -> bool:
    """Whether a u8 RGB batch is NHWC [B,H,W,3] rather than planar
    [B,3,H,W]. H and W are multiples of 2*tiles, never 3, so the shape tells
    the layouts apart."""
    return x_u8.ndim == 4 and x_u8.shape[1] != 3


def clahe_luma_apply_u8_plain(
    x_u8: torch.Tensor, y: torch.Tensor, luts: torch.Tensor, row0: int = 0, cell_rows: int | None = None
) -> torch.Tensor:
    """Plain version of K7: LUT blend on y, then the RGB gain, in the
    input's layout; the rows are the frame's cell rows [row0, row0 +
    cell_rows) (by default the whole frame)."""
    if _is_nhwc(x_u8):
        planar = clahe_luma_apply_u8_plain(x_u8.permute(0, 3, 1, 2), y, luts, row0, cell_rows)
        return planar.permute(0, 2, 3, 1).contiguous()
    return _gain_u8(x_u8, y, apply_from_cells(y, luts, row0, cell_rows))


def clahe_luma_apply_u8_fused_plain(xp_u8: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: K7's with y recomputed from the RGB."""
    return clahe_luma_apply_u8_plain(xp_u8, _luma_u8(xp_u8), luts)


# The kernels stage two tile rows of LUTs as f32, 2 * 256 * 4 bytes for
# each x-tile, and 256 reciprocals, in at most 227 KB of shared memory.
_LUT_SMEM_PER_TILE = 2 * 256 * 4
_SMEM_MAX = 232448 - 256 * 4


@functools.lru_cache(maxsize=None)
def luma_geometry(
    h: int, w: int, tiles_y: int, tiles_x: int, device: str, row0: int = 0, cell_rows: int | None = None
) -> torch.Tensor:
    """The blend geometry K7 and K9 read, int32 [2 w + h + 256]: per column
    the x-weight (f32 bits), then the two neighbour tiles' LUT offsets
    t0x * 256 | t1x * 256 << 16, then per row the y-weight (f32 bits; of
    the frame's cell rows [row0, row0 + cell_rows) for a slab), then the f32
    reciprocals 1 / d of d = 1..256 (bits) for the gain's quotient; made
    once per shape on the CPU, the weights by the plain version's own
    ``_cell_maps``."""
    t0x, t1x, xa = _cell_maps(w, tiles_x, "cpu")
    ya = _cell_maps(h, tiles_y, "cpu", row0, cell_rows)[2]
    offs = (t0x * 256) | ((t1x * 256) << 16)
    rcp = 1.0 / torch.arange(1, 257, dtype=torch.float32)
    parts = [xa.float().view(torch.int32), offs.to(torch.int32), ya.float().view(torch.int32), rcp.view(torch.int32)]
    return torch.cat(parts).to(device)


def _check_apply(xp_u8: torch.Tensor, luts: torch.Tensor, what: str) -> tuple[int, int]:
    _check_planar_u8(xp_u8, what)
    b, _, h, w = xp_u8.shape
    return _check_luts(luts, b, h, w, xp_u8.device, what, smem_per_tile=_LUT_SMEM_PER_TILE, smem_max=_SMEM_MAX)


def _rgb_u8_like(
    x_u8: torch.Tensor, y: torch.Tensor, luts: torch.Tensor, row0: int = 0, cell_rows: int | None = None
) -> torch.Tensor:
    """Fake implementation of K7: u8 RGB in the input's shape and layout."""
    return torch.empty_like(x_u8)


@_kernels.operator("clahe_luma_apply_u8", _rgb_u8_like)
def clahe_luma_apply_u8(
    x_u8: torch.Tensor, y: torch.Tensor, luts: torch.Tensor, row0: int = 0, cell_rows: int | None = None
) -> torch.Tensor:
    """K7: u8 RGB, planar [B,3,H,W] or NHWC [B,H,W,3], + u8 luma [B,H,W]
    + u8 LUTs [B,ty,tx,256] -> u8 RGB in the same layout. The rows may be a
    slab of the frame's cell rows [row0, row0 + cell_rows), the LUTs the
    frame's."""
    what = "clahe_luma_apply_u8"
    nhwc = _is_nhwc(x_u8)
    if nhwc:
        _check_nhwc_u8(x_u8, what)
        b, h, w, _ = x_u8.shape
    else:
        _check_planar_u8(x_u8, what)
        b, _, h, w = x_u8.shape
    tiles_y, tiles_x = _check_luts(luts, b, h, w, x_u8.device, what, smem_per_tile=_LUT_SMEM_PER_TILE,
                                   smem_max=_SMEM_MAX, row0=row0, cell_rows=cell_rows)
    row0, cell_rows = slab_cells(h, tiles_y, row0, cell_rows)
    if y.dtype != torch.uint8 or tuple(y.shape) != (b, h, w) or not y.is_contiguous() or y.device != x_u8.device:
        raise ValueError(f"{what}: expected contiguous uint8 luma {(b, h, w)}, got {y.dtype} {tuple(y.shape)}")
    if x_u8.device.type == "cpu":
        return clahe_luma_apply_u8_plain(x_u8, y, luts, row0, cell_rows)
    stream = _kernels.stream(x_u8)
    out = torch.empty_like(x_u8)
    geo = luma_geometry(h, w, tiles_y, tiles_x, str(x_u8.device), row0, cell_rows)
    _kernels.launch(
        "clahe_luma_apply_u8_nhwc" if nhwc else "clahe_luma_apply_u8", x_u8.data_ptr(), y.data_ptr(),
        luts.data_ptr(), geo.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x, row0, cell_rows, stream,
    )
    LAUNCHES["clahe_luma_apply_u8"] += 1
    SLAB_LAUNCHES["clahe_luma_apply_u8"] += row0 > 0
    return out


def clahe_luma_apply_u8_fused(xp_u8: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K9: K7 with the luma recomputed inside the kernel (no luma operand)."""
    tiles_y, tiles_x = _check_apply(xp_u8, luts, "clahe_luma_apply_u8_fused")
    b, _, h, w = xp_u8.shape
    if xp_u8.device.type == "cpu":
        return clahe_luma_apply_u8_fused_plain(xp_u8, luts)
    stream = _kernels.stream(xp_u8)
    out = torch.empty_like(xp_u8)
    geo = luma_geometry(h, w, tiles_y, tiles_x, str(xp_u8.device))
    _kernels.launch(
        "clahe_luma_apply_u8_fused", xp_u8.data_ptr(), luts.data_ptr(), geo.data_ptr(), out.data_ptr(),
        b, h, w, tiles_y, tiles_x, stream,
    )
    LAUNCHES["clahe_luma_apply_u8_fused"] += 1
    return out


# ---------------------------------------------------------------- pipelines


def clahe_luma_rgb_u8_planar(
    xp_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    fuse_luma: bool = False,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """Planar uint8 luma-gain CLAHE: [B, 3, H, W] -> [B, 3, H, W], K2 -> K7
    (K9 with ``fuse_luma``).

    H and W must be multiples of 2*tiles (any such size: the TPU's cell
    width limit does not apply). ``hist_subsample=s`` builds the tile
    histograms from a within-cell s x s decimation of the luma plane; with
    ``fuse_luma`` the luma is computed only at those samples for the
    histograms, and the apply kernel recomputes it per pixel."""
    _check_planar_u8(xp_u8, "clahe_luma_rgb_u8_planar")
    b, _, h, w = xp_u8.shape
    _check_cells(h, w, tiles_y, tiles_x)
    if hist_subsample < 1:
        raise ValueError(f"hist_subsample must be >= 1, got {hist_subsample}")
    if fuse_luma:
        s = hist_subsample
        ncy, ncx = 2 * tiles_y, 2 * tiles_x
        xd = xp_u8.reshape(b, 3, ncy, h // ncy, ncx, w // ncx)[:, :, :, ::s, :, ::s]
        y_cells = _luma_u8(xd.reshape(b, 3, ncy * xd.shape[3], ncx * xd.shape[5]))
        luts = clahe_tables(y_cells.contiguous(), clip_limit, tiles_y, tiles_x)
        return clahe_luma_apply_u8_fused(xp_u8, luts)
    y = _luma_u8(xp_u8)
    luts = clahe_tables(y, clip_limit, tiles_y, tiles_x, hist_subsample)
    return clahe_luma_apply_u8(xp_u8, y, luts)


def clahe_luma_rgb_u8(
    x_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """uint8 NHWC (or HWC) luma-gain CLAHE (cell-divisible shapes), K2 ->
    K7 on the NHWC batch itself: the luma and the output keep its layout,
    with no transpose."""
    squeeze = x_u8.ndim == 3
    if squeeze:
        x_u8 = x_u8[None]
    x_u8 = x_u8.contiguous()
    _check_nhwc_u8(x_u8, "clahe_luma_rgb_u8")
    _check_cells(x_u8.shape[1], x_u8.shape[2], tiles_y, tiles_x)
    y = _luma_u8(x_u8, dim=3)
    luts = clahe_tables(y, clip_limit, tiles_y, tiles_x, hist_subsample)
    out = clahe_luma_apply_u8(x_u8, y, luts)
    return out[0] if squeeze else out


def clahe_luma_rgb_u8_xla(
    x_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """The plain formulation of the same algorithm, any shape, any device
    (named after the JAX package's XLA oracle, which it reproduces): the
    plain cell-view CLAHE on the luma plane, or ``clahe_u8`` where the shape
    is not cell-divisible (which ignores ``hist_subsample``)."""
    squeeze = x_u8.ndim == 3
    if squeeze:
        x_u8 = x_u8[None]
    xp = x_u8.permute(0, 3, 1, 2)
    y = _luma_u8(xp)
    y_eq = clahe_u8_fast(y, clip_limit=clip_limit, tiles_x=tiles_x, tiles_y=tiles_y, hist_subsample=hist_subsample)
    out = _gain_u8(xp, y, y_eq).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _note_plain_route(h: int, w: int, tiles: int) -> None:
    log.info(
        "clahe_luma_rgb: %dx%d is not a multiple of %d; the plain clahe_luma_rgb_u8_xla runs "
        "(the luma kernels take cell-divisible shapes)", h, w, 2 * tiles,
    )


def clahe_luma_rgb(
    x: torch.Tensor,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """Float [0,1] NHWC/HWC luma-gain CLAHE (the ``clahe_luma`` enhance mode).

    Cell-divisible shapes run the kernel pipeline (plain versions on the
    CPU); other shapes run the plain ``clahe_luma_rgb_u8_xla``."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    xq = torch.clamp(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8)
    h, w = x.shape[1], x.shape[2]
    if cell_divisible(h, w, tiles, tiles):
        out_u8 = clahe_luma_rgb_u8(xq, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles, hist_subsample=hist_subsample)
    else:
        _note_plain_route(h, w, tiles)
        out_u8 = clahe_luma_rgb_u8_xla(
            xq, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles, hist_subsample=hist_subsample
        )
    out = ieee_div(out_u8.to(torch.float32), 255.0)
    return out[0] if squeeze else out
