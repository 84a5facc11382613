"""CLAHE (Contrast-Limited Adaptive Histogram Equalization) in PyTorch.

Counterpart of ``retinex_tpu/ops/clahe.py``; reproduces
cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8,8)).apply(L) on the L channel:

1. Pad to a tile-divisible size with BORDER_REFLECT_101 on right/bottom.
2. Per tile: 256-bin histogram; clip bins at clipLimit*tileArea/256 (min 1);
   redistribute the excess evenly, then the residual one count per bin with
   stride max(256/residual, 1); no re-clip after redistribution.
3. LUT[i] = round(cumsum(hist)[i] * 255 / tileArea), saturating cast.
4. Each output pixel bilinearly interpolates the 4 neighbouring tile LUTs.

``clahe_u8`` is the plain gather formulation for any shape, in two halves:
``padded_tile_hist`` (the reflect-101 padded tiles' histograms) and
``blend_tiles`` (the four-neighbour blend).
``clahe_lab_rgb`` on the card takes every shape to the three kernels in
ops/clahe_gather.py: cell-divisible shapes (H, W multiples of 2*tiles) in
their cell modes, every other shape in their tile modes, which compute
``clahe_u8``'s semantics. On the CPU it routes as the JAX package routes:
cell-divisible shapes to the kernels' plain versions, every other shape to
``clahe_u8``.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from retinex_tpu_torch.ops.colorspace import ieee_div, lab_u8_to_rgb, srgb_bytes_to_lab_u8

HIST_SIZE = 256

log = logging.getLogger(__name__)


def _luts_from_hist(hist: torch.Tensor, clip_limit: float, tile_area: int) -> torch.Tensor:
    """OpenCV clip/redistribute/CDF on per-tile histograms.

    hist: int [..., 256]. Returns int32 LUTs [..., 256] with values in [0,255].
    Integer math throughout; the CDF scale is the f32 value of 255/area, as
    the JAX package multiplies it.
    """
    clip = max(int(clip_limit * tile_area / HIST_SIZE), 1)
    hist = hist.to(torch.int64)
    bins = torch.arange(HIST_SIZE, dtype=torch.int64, device=hist.device)
    clipped = torch.clamp(hist, max=clip)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    redist = excess // HIST_SIZE
    residual = excess - redist * HIST_SIZE
    step = torch.clamp(HIST_SIZE // torch.clamp(residual, min=1), min=1)
    gets_one = (bins % step == 0) & (bins // step < residual)
    hist3 = clipped + redist + gets_one.to(torch.int64)
    cdf = torch.cumsum(hist3, dim=-1).to(torch.float32)
    lut_scale = torch.tensor(np.float32(float(HIST_SIZE - 1) / float(tile_area)), device=hist.device)
    return torch.clamp(torch.round(cdf * lut_scale), 0, 255).to(torch.int32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c): a*b + c with one rounding to f32.

    The JAX package's CPU programs contract the multiply-adds of the CLAHE
    blend (and of the tile coordinate) into fused multiply-adds, so a plain
    f32 ``a*b + c`` rounds differently at exact .5 ties. For the operands
    here (u8-range values, their blends, f32 weights and pixel indices) the
    float64 product and sum are exact, so one rounding to f32 is the FMA's
    result. The CUDA kernel calls fmaf at the same places."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _tile_hist(tiles: torch.Tensor) -> torch.Tensor:
    """tiles: int [..., T, P] values in [0,255] -> int64 histograms [..., T, 256].

    Counted by a scatter-add into the known number of bins, not by
    ``bincount``, whose output size depends on the data: ``torch.export``
    would fix the batch of a serving artifact there (infer/serving.py)."""
    lead = tiles.shape[:-1]
    flat = tiles.reshape(-1, tiles.shape[-1]).to(torch.int64)
    offs = torch.arange(flat.shape[0], device=tiles.device)[:, None] * HIST_SIZE
    idx = (flat + offs).reshape(-1)
    hist = torch.zeros(flat.shape[0] * HIST_SIZE, dtype=torch.int64, device=tiles.device)
    return hist.scatter_add(0, idx, torch.ones_like(idx)).reshape(*lead, HIST_SIZE)


def _interp_maps(h: int, w: int, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int, device=None):
    """Bilinear interpolation maps between tile LUTs (OpenCV semantics).

    The coordinate is i/tile - 0.5 as XLA compiles it: the division by a
    constant becomes a multiply by its f32 reciprocal, fused with the -0.5."""

    def coord(n: int, tile: int) -> torch.Tensor:
        i = torch.arange(n, dtype=torch.float32, device=device)
        recip = torch.full_like(i, 1.0 / tile)
        return _fma(i, recip, torch.full_like(i, -0.5))

    ys = coord(h, tile_h)
    xs = coord(w, tile_w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ya = ys - y0
    xa = xs - x0
    y0i = torch.clamp(y0.long(), 0, tiles_y - 1)
    y1i = torch.clamp(y0.long() + 1, 0, tiles_y - 1)
    x0i = torch.clamp(x0.long(), 0, tiles_x - 1)
    x1i = torch.clamp(x0.long() + 1, 0, tiles_x - 1)
    return (y0i, y1i, ya), (x0i, x1i, xa)


def _reflect101_index(n: int, pad: int) -> np.ndarray:
    idx = np.arange(n + pad)
    return np.where(idx < n, idx, 2 * (n - 1) - idx)


def tile_dims(h: int, w: int, tiles_y: int, tiles_x: int) -> tuple[int, int, int, int]:
    """(pad_h, pad_w, tile_h, tile_w) of an h x w frame padded (reflect-101,
    bottom and right) to whole tiles."""
    pad_h, pad_w = (-h) % tiles_y, (-w) % tiles_x
    return pad_h, pad_w, (h + pad_h) // tiles_y, (w + pad_w) // tiles_x


def padded_tile_hist(img: torch.Tensor, tiles_y: int, tiles_x: int) -> tuple[torch.Tensor, int]:
    """Histograms of the reflect-101 padded tiles of [B, H, W] values in
    [0, 255]: (int64 [B, tiles_y, tiles_x, 256], tile area)."""
    b, h, w = img.shape
    pad_h, pad_w, tile_h, tile_w = tile_dims(h, w, tiles_y, tiles_x)
    rows = torch.as_tensor(_reflect101_index(h, pad_h), device=img.device)
    cols = torch.as_tensor(_reflect101_index(w, pad_w), device=img.device)
    padded = img.to(torch.int32).index_select(1, rows).index_select(2, cols)
    tile_area = tile_h * tile_w
    tiles = padded.reshape(b, tiles_y, tile_h, tiles_x, tile_w)
    tiles = tiles.permute(0, 1, 3, 2, 4).reshape(b, tiles_y * tiles_x, tile_area)
    return _tile_hist(tiles).reshape(b, tiles_y, tiles_x, HIST_SIZE), tile_area


def blend_tiles(img: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """clahe_u8's blend: each pixel of [B, H, W] values in [0, 255] through
    the LUTs [B, tiles_y, tiles_x, 256] of its four neighbour tiles, blended
    by its tile coordinate (``_interp_maps``) -> int32 [B, H, W]."""
    b, h, w = img.shape
    _, tiles_y, tiles_x, _ = luts.shape
    dev = img.device
    _, _, tile_h, tile_w = tile_dims(h, w, tiles_y, tiles_x)
    (y0i, y1i, ya), (x0i, x1i, xa) = _interp_maps(h, w, tiles_y, tiles_x, tile_h, tile_w, dev)
    luts_flat = luts.to(torch.int32).reshape(b, tiles_y * tiles_x * HIST_SIZE)
    v = img.long()

    def lut_at(yi, xi):
        flat = (yi[:, None] * tiles_x + xi[None, :]) * HIST_SIZE  # [h, w]
        idx = (flat[None] + v).reshape(b, -1)
        return torch.gather(luts_flat, 1, idx).reshape(b, h, w).to(torch.float32)

    l00 = lut_at(y0i, x0i)
    l01 = lut_at(y0i, x1i)
    l10 = lut_at(y1i, x0i)
    l11 = lut_at(y1i, x1i)

    ya2 = ya[None, :, None]
    xa2 = xa[None, None, :]
    top = _fma(l00, 1.0 - xa2, l01 * xa2)
    bot = _fma(l10, 1.0 - xa2, l11 * xa2)
    return torch.clamp(torch.round(_fma(top, 1.0 - ya2, bot * ya2)), 0, 255).to(torch.int32)


def clahe_u8(
    img_u8: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
) -> torch.Tensor:
    """OpenCV-parity CLAHE on uint8 single-channel images of any shape.

    img_u8: [B, H, W] (or [H, W]) values in [0,255] -> int32, same shape.
    """
    squeeze = img_u8.ndim == 2
    if squeeze:
        img_u8 = img_u8[None]
    img = img_u8.to(torch.int32)
    hist, tile_area = padded_tile_hist(img, tiles_y, tiles_x)
    out = blend_tiles(img, _luts_from_hist(hist, clip_limit, tile_area))
    return out[0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _note_plain_route(h: int, w: int, tiles: int) -> None:
    log.info(
        "clahe_lab_rgb: %dx%d is not a multiple of %d; on the CPU plain clahe_u8 runs "
        "(on the card the CLAHE kernels in their tile modes)", h, w, 2 * tiles,
    )


def cell_divisible(h: int, w: int, tiles_y: int, tiles_x: int) -> bool:
    """Shapes the CLAHE kernels' cell modes take: H and W multiples of 2*tiles."""
    return h % (2 * tiles_y) == 0 and w % (2 * tiles_x) == 0


def clahe_lab_rgb(
    x: torch.Tensor,
    clip_limit: float = 2.0,
    tiles: int = 8,
    hist_subsample: int = 1,
) -> torch.Tensor:
    """The reference's Lab-CLAHE pipeline: round to u8, RGB->Lab, CLAHE on L
    only, a/b passed through, Lab->RGB, back to float [0,1].

    x: float [0,1] NHWC (or HWC). Cell-divisible shapes run the kernel
    pipeline (ops/clahe_gather.py, the kernels' plain versions on the CPU);
    `hist_subsample=s` builds its tile histograms from a within-cell s x s
    decimation. Other shapes have exact histograms of the padded tiles and
    ignore the knob: on the card K1-K3 in their tile modes
    (``clahe_gather.clahe_lab_rgb_tiles``), on the CPU the plain
    ``clahe_u8`` with ``srgb_bytes_to_lab_u8``'s Lab bytes (K1's plain
    version) and ``lab_u8_to_rgb``. The card gives the CPU's bytes.
    """
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    if cell_divisible(h, w, tiles, tiles):
        from retinex_tpu_torch.ops.clahe_gather import clahe_lab_rgb_gather

        out = clahe_lab_rgb_gather(
            x, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles, hist_subsample=hist_subsample
        )
        return out[0] if squeeze else out
    if x.device.type != "cpu":
        from retinex_tpu_torch.ops.clahe_gather import clahe_lab_rgb_tiles

        out = clahe_lab_rgb_tiles(x, clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles)
        return out[0] if squeeze else out
    _note_plain_route(h, w, tiles)
    lab = srgb_bytes_to_lab_u8(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8), -1)
    l_eq = clahe_u8(lab[..., 0], clip_limit=clip_limit, tiles_x=tiles, tiles_y=tiles)
    lab_eq = torch.stack([l_eq.float(), lab[..., 1].float(), lab[..., 2].float()], dim=-1)
    out = ieee_div(torch.round(lab_u8_to_rgb(lab_eq) * 255.0), 255.0)
    return out[0] if squeeze else out
