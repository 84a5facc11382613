"""Cell-view CLAHE in plain PyTorch: the oracle of the CLAHE kernels.

Counterpart of ``retinex_tpu/ops/clahe_fast.py`` (its math, not its
TPU-specific nibble one-hot algebra). The image is cut into half-tile
"cells": within a cell the 4 neighbouring tile LUTs are fixed, and the
bilinear weights depend only on the pixel's offset in the cell and the cell's
parity. Bit-identical to ``clahe_u8`` whenever H is a multiple of 2*tiles_y
and W of 2*tiles_x; other shapes fall back to ``clahe_u8``.

``hist_subsample=s`` builds each tile histogram from a within-cell s x s
decimation (rows ``::s`` and columns ``::s`` of every cell); the clip
threshold and CDF scale follow the sampled area ``4*ceil(hh/s)*ceil(hw/s)``.

The apply also takes a slab of whole cell rows of a frame (``row0``, the
frame's cell row where the slab starts, and ``cell_rows``, the slab's count)
with the frame's LUTs, as the JAX package's ``_apply_from_cells(...,
row0=...)`` does for its H-sharded CLAHE (``parallel/spatial.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from retinex_tpu_torch.ops.clahe import HIST_SIZE, _fma, _luts_from_hist, _tile_hist, clahe_u8


def _neighbor_index_tables(tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """For cell index c in [0, 2*tiles): the two neighbouring tile indices
    (floor and floor+1 of the interpolation coordinate), clipped. The floor
    division matters at c = 0: floor(-1/2) = -1 clips to tile 0."""
    c = np.arange(2 * tiles)
    t0 = np.clip((c - 1) // 2, 0, tiles - 1)
    t1 = np.clip((c - 1) // 2 + 1, 0, tiles - 1)
    return t0, t1


def _blend_weights(cell: int) -> np.ndarray:
    """[2, cell] f32 fractional interpolation weight by (cell parity, offset):
    even cells sit in the upper half of a tile (0.5..1), odd cells in the
    lower half (0..0.5)."""
    u = np.arange(cell, dtype=np.float32)
    even = u / np.float32(2.0 * cell) + np.float32(0.5)
    odd = u / np.float32(2.0 * cell)
    return np.stack([even, odd], axis=0)


def _hist_from_cells(
    l_u8: torch.Tensor, tiles_y: int, tiles_x: int, hist_subsample: int = 1
) -> tuple[torch.Tensor, int]:
    """Per-tile histograms of a cell-divisible [b, H, W] plane.

    Returns (int64 [b, tiles_y, tiles_x, 256], sampled tile area)."""
    b, h, w = l_u8.shape
    ncy, ncx = 2 * tiles_y, 2 * tiles_x
    hh, hw = h // ncy, w // ncx
    s = hist_subsample
    v = l_u8.reshape(b, ncy, hh, ncx, hw)[:, :, ::s, :, ::s]
    hh2, hw2 = v.shape[2], v.shape[4]
    tiles = (
        v.reshape(b, tiles_y, 2, hh2, tiles_x, 2, hw2)
        .permute(0, 1, 4, 2, 3, 5, 6)
        .reshape(b, tiles_y * tiles_x, 4 * hh2 * hw2)
    )
    hist = _tile_hist(tiles).reshape(b, tiles_y, tiles_x, HIST_SIZE)
    return hist, 4 * hh2 * hw2


def slab_cells(h: int, tiles_y: int, row0: int = 0, cell_rows: int | None = None) -> tuple[int, int]:
    """(row0, cell_rows) of an h-row slab of whole cell rows, the first the
    frame's cell row `row0` (``cell_rows`` None: the whole frame, 2 *
    tiles_y); raises where the slab does not lie in the frame's cell rows."""
    cell_rows = 2 * tiles_y if cell_rows is None else cell_rows
    if cell_rows < 1 or row0 < 0 or row0 + cell_rows > 2 * tiles_y or h % cell_rows:
        raise ValueError(
            f"a slab of {h} rows as cell rows [{row0}, {row0 + cell_rows}) of a {2 * tiles_y}-cell-row frame: "
            "the cell rows must lie in the frame and divide the rows"
        )
    return row0, cell_rows


def _cell_maps(n: int, tiles: int, device, row0: int = 0, cells: int | None = None):
    """Per-row (or per-column) neighbour tiles and blend weight for a
    cell-divisible extent n: (t0 [n], t1 [n], weight [n] f32). A slab of
    `cells` whole cells (default 2 * tiles) whose first is the frame's cell
    `row0` takes the frame's tiles and parities."""
    cell = n // (2 * tiles if cells is None else cells)
    c = np.arange(n) // cell + row0
    t0, t1 = _neighbor_index_tables(tiles)
    wt = _blend_weights(cell)[c % 2, np.arange(n) % cell]
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return as_t(t0[c]), as_t(t1[c]), as_t(wt)


def apply_from_cells(
    l_u8: torch.Tensor, luts: torch.Tensor, row0: int = 0, cell_rows: int | None = None
) -> torch.Tensor:
    """LUT lookup of the 4 neighbour tiles + bilinear blend.

    l_u8: [b, H, W] values in [0,255]; luts: [b, tiles_y, tiles_x, 256], the
    frame's. The H rows are the frame's cell rows [row0, row0 + cell_rows)
    (default: the whole frame, ``slab_cells``). Returns the new L plane,
    int32 [b, H, W]."""
    b, h, w = l_u8.shape
    _, tiles_y, tiles_x, _ = luts.shape
    dev = l_u8.device
    row0, cell_rows = slab_cells(h, tiles_y, row0, cell_rows)
    t0y, t1y, ya = _cell_maps(h, tiles_y, dev, row0, cell_rows)
    t0x, t1x, xa = _cell_maps(w, tiles_x, dev)
    luts_flat = luts.reshape(b, -1).to(torch.int64)
    v = l_u8.to(torch.int64)

    def lut_at(ty, tx):
        flat = (ty[:, None] * tiles_x + tx[None, :]) * HIST_SIZE
        idx = (flat[None] + v).reshape(b, -1)
        return torch.gather(luts_flat, 1, idx).reshape(b, h, w).to(torch.float32)

    l00, l01 = lut_at(t0y, t0x), lut_at(t0y, t1x)
    l10, l11 = lut_at(t1y, t0x), lut_at(t1y, t1x)
    return blend(l00, l01, l10, l11, xa[None, None, :], ya[None, :, None])


def blend(l00, l01, l10, l11, xa, ya) -> torch.Tensor:
    """Bilinear blend of the 4 neighbour LUT values, rounded to the new L.

    The three multiply-adds are contracted as the JAX package's compiled CPU
    program contracts them in ``clahe_u8_fast`` (which product each FMA
    absorbs; see ``_fma``), so the result is bit-identical to it; the CUDA
    kernel makes the same three fmaf calls."""
    top = _fma(l01, xa, l00 * (1.0 - xa))
    bot = _fma(l10, 1.0 - xa, l11 * xa)
    return torch.clamp(torch.round(_fma(top, 1.0 - ya, bot * ya)), 0, 255).to(torch.int32)


def clahe_u8_fast(
    img_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """Cell-view CLAHE on [B, H, W] (or [H, W]) u8 values -> int32.

    On shapes that are not cell-divisible the exact ``clahe_u8`` runs and
    `hist_subsample` is ignored."""
    if hist_subsample < 1:
        raise ValueError(f"hist_subsample must be >= 1, got {hist_subsample}")
    squeeze = img_u8.ndim == 2
    if squeeze:
        img_u8 = img_u8[None]
    _, h, w = img_u8.shape
    if h % (2 * tiles_y) or w % (2 * tiles_x):
        out = clahe_u8(img_u8, clip_limit, tiles_x, tiles_y)
    else:
        hist, area = _hist_from_cells(img_u8, tiles_y, tiles_x, hist_subsample)
        out = apply_from_cells(img_u8, _luts_from_hist(hist, clip_limit, area))
    return out[0] if squeeze else out
