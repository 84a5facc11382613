"""The older fused Lab-CLAHE on two CUDA kernels, with its plain version.

Counterpart of ``retinex_tpu/ops/clahe_pallas.py`` (``clahe_lab_rgb_pallas``);
the name is kept so a reader finds it, but nothing here is Pallas. The
JAX package's routes no longer reach it (its Lab-CLAHE runs the gather
kernels, ``ops/clahe_gather.py``); its tests and ``scripts/perf_lab.py``
call it as a standalone op, and so may a user of the port. Its two kernels
are instances of K1's and K3's bodies in ``retinex_tpu_torch/csrc/clahe_lab.cu``:

- ``clahe_pallas_hist`` (K16, the ``_hist_kernel`` half, ``lab_hist_kernel``):
  f32 NHWC RGB -> u8-quantised RGB -> 8-bit-scale Lab, rounded to u8 and
  written as planar u8 [B,3,H,W], and the 256-bin histogram of every
  tile's L, int32 [B, tiles_y, tiles_x, 256];
- ``clahe_pallas_apply`` (K16, the ``_apply_kernel`` half,
  ``clahe_apply_kernel`` in its K16 mode): the 4 neighbour LUTs of every
  pixel blended with K16's weights, rounded to the new L, then Lab -> f32
  NHWC RGB at ``round(v * 255) / 255``.

The LUT build between them (clip, redistribute, CDF) stays plain PyTorch,
as the JAX package leaves it to XLA (``ops/clahe._luts_from_hist``). The
TPU's cell layout (a transpose in and out) has no counterpart: both
kernels index NHWC f32 directly.

K16's colour arithmetic is its own, not ``ops/colorspace.py``'s (which K1
and K3 follow): the sRGB de-gamma as ``((x + 0.055) / 1.055) ** 2.4`` and
the cube root as ``max(t, 1e-12) ** (1/3)``. The plain version reproduces
the compiled CPU program of the JAX function: a division by a constant
runs as a multiply by its f32 reciprocal, and the blend weights'
multiply-adds are fused (see ``_blend``). The kernels read what depends on
one byte from tables built here by the plain version's own operations
(``degamma_table_k16``, on the kernel's card, as the plain version there
computes it; fy and Y by L, ``apply_table_block_k16``), and quantise
linear light with K3's quantiser, which computes the CPU plain version's
byte for every f32 (tests/test_torch_clahe_pallas_tables.py). The first
kernel takes the cube root as cbrtf, and powf near a rounding tie, which
gives the plain version's bytes on the card.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES``
counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from retinex_tpu_torch.ops import _kernels
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops.clahe import HIST_SIZE, _fma, _luts_from_hist, _tile_hist, cell_divisible
from retinex_tpu_torch.ops.clahe_fast import _neighbor_index_tables

# D65 constants of retinex_tpu/ops/clahe_pallas.py (OpenCV 8-bit Lab).
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_XN = 0.950456
_ZN = 1.088754

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"clahe_pallas_hist": 0, "clahe_pallas_apply": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rc(c: float) -> float:
    """The f32 reciprocal of the f32 constant c: what a division by c runs
    as in the JAX function's compiled program."""
    return float(np.float32(1.0) / np.float32(c))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    cuberoot = torch.pow(torch.clamp(t, min=1e-12), 1.0 / 3.0)
    return torch.where(t > 0.008856, cuberoot, _fma(torch.full_like(t, 7.787), t, torch.full_like(t, 16.0 / 116.0)))


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 6.0 / 29.0, ft * ft * ft, (ft - 16.0 / 116.0) * _rc(7.787))


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x * _rc(12.92), ((x + 0.055) * _rc(1.055)) ** 2.4)


def _linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    """sRGB of linear light clamped at 0 (the clamp to [0, 1] follows)."""
    lin = torch.clamp(lin, min=0.0)
    return torch.where(lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1.0 / 2.4) - 0.055)


def _rgb_to_lab_u8scale(r, g, b):
    """u8-quantised sRGB channels -> (L, a, b) in OpenCV's 8-bit scale."""
    return _lab_u8scale_of_linear(_srgb_to_linear(r), _srgb_to_linear(g), _srgb_to_linear(b))


def _lab_u8scale_of_linear(rl, gl, bl):
    """Linear-light channels -> (L, a, b) in OpenCV's 8-bit scale."""
    m = _RGB2XYZ
    X = (m[0][0] * rl + m[0][1] * gl + m[0][2] * bl) * _rc(_XN)
    Y = m[1][0] * rl + m[1][1] * gl + m[1][2] * bl
    Z = (m[2][0] * rl + m[2][1] * gl + m[2][2] * bl) * _rc(_ZN)
    fx, fy, fz = _lab_f(X), _lab_f(Y), _lab_f(Z)
    full = lambda v: torch.full_like(fy, v)  # noqa: E731
    L8 = _fma(full(116.0), fy, full(-16.0)) * 2.55
    a8 = _fma(full(500.0), fx - fy, full(128.0))
    b8 = _fma(full(200.0), fy - fz, full(128.0))
    return L8, a8, b8


def _fy(L8: torch.Tensor) -> torch.Tensor:
    return (L8 * (100.0 / 255.0) + 16.0) * _rc(116.0)


def _lab_u8scale_to_rgb(L8, a8, b8):
    """(L, a, b) in OpenCV's 8-bit scale -> sRGB channels in [0, 1]."""
    fy = _fy(L8)
    fx = _fma(a8 - 128.0, torch.full_like(fy, _rc(500.0)), fy)
    fz = _fma(128.0 - b8, torch.full_like(fy, _rc(200.0)), fy)
    Y = _lab_f_inv(fy)
    X = _lab_f_inv(fx) * _XN
    Z = _lab_f_inv(fz) * _ZN
    m = _XYZ2RGB
    out = []
    for c in range(3):
        out.append(torch.clamp(_linear_to_srgb(m[c][0] * X + m[c][1] * Y + m[c][2] * Z), 0.0, 1.0))
    return out


# ---------------------------------------------------------------- the kernels' tables


@functools.lru_cache(maxsize=None)
def degamma_table_k16(device: str) -> torch.Tensor:
    """f32 [256]: K16's de-gamma of each quantised byte v, srgb_to_linear(v
    * (1/255)) by the plain version's operations on `device`, so that the
    kernel there de-gammas as its plain version there does."""
    return _srgb_to_linear(torch.arange(HIST_SIZE, dtype=torch.float32, device=device) * _rc(255.0))


def apply_tables_k16() -> dict[str, torch.Tensor]:
    """K16's apply tables on the CPU: fy and Y = f^-1(fy) by L, each by the
    plain version's own operations, and K3's quantiser buckets."""
    fy = _fy(torch.arange(HIST_SIZE, dtype=torch.float32))
    return {"fy": fy, "y": _lab_f_inv(fy), "quant": cg.apply_tables()["quant"]}


@functools.lru_cache(maxsize=None)
def apply_table_block_k16(device: str) -> torch.Tensor:
    """int32 [APPLY_TABLE_WORDS]: ``apply_tables_k16`` in K3's layout."""
    return cg.table_words(apply_tables_k16()).to(device)


# ---------------------------------------------------------------- checks


def _check_rgb(x: torch.Tensor, tiles_y: int, tiles_x: int, what: str) -> None:
    if x.dtype != torch.float32 or x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"{what}: expected float32 [B, H, W, 3] or [H, W, 3], got {x.dtype} {tuple(x.shape)}")
    if not cell_divisible(x.shape[1], x.shape[2], tiles_y, tiles_x):
        raise ValueError(f"shape {tuple(x.shape[1:3])} not divisible by 2x tile grid")


# ---------------------------------------------------------------- K16, histogram half


def clahe_pallas_hist_plain(x: torch.Tensor, tiles_y: int = 8, tiles_x: int = 8):
    """Plain version of K16's first kernel: f32 NHWC [B,H,W,3] -> (planar
    u8 Lab [B,3,H,W], int32 tile histograms of L [B, tiles_y, tiles_x, 256])."""
    xq = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) * _rc(255.0)
    lab = _rgb_to_lab_u8scale(xq[..., 0], xq[..., 1], xq[..., 2])
    lab = torch.stack([torch.clamp(torch.round(ch), 0.0, 255.0) for ch in lab], dim=1).to(torch.uint8)
    return lab, l_histograms(lab, tiles_y, tiles_x)


def l_histograms(lab: torch.Tensor, tiles_y: int, tiles_x: int) -> torch.Tensor:
    """int32 [B, tiles_y, tiles_x, 256]: the histogram of each tile's L in
    planar u8 Lab [B,3,H,W]."""
    b, _, h, w = lab.shape
    th, tw = h // tiles_y, w // tiles_x
    tiles = lab[:, 0].reshape(b, tiles_y, th, tiles_x, tw).permute(0, 1, 3, 2, 4).reshape(b, tiles_y, tiles_x, th * tw)
    return _tile_hist(tiles).to(torch.int32)


def clahe_pallas_hist(x: torch.Tensor, tiles_y: int = 8, tiles_x: int = 8):
    """K16, first kernel: f32 NHWC RGB [B,H,W,3] (H, W multiples of 2*tiles)
    -> (planar u8 Lab [B,3,H,W], int32 histograms [B, tiles_y, tiles_x, 256])."""
    _check_rgb(x, tiles_y, tiles_x, "clahe_pallas_hist")
    if not x.is_contiguous():
        raise ValueError("clahe_pallas_hist: tensor must be contiguous")
    if x.device.type == "cpu":
        return clahe_pallas_hist_plain(x, tiles_y, tiles_x)
    stream = _kernels.stream(x)
    b, h, w, _ = x.shape
    lab = torch.empty((b, 3, h, w), dtype=torch.uint8, device=x.device)
    hist = torch.zeros((b, tiles_y, tiles_x, HIST_SIZE), dtype=torch.int32, device=x.device)
    if b == 0:
        return lab, hist
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    strips, rows = cg.tables_plan(h, tiles_y, tiles_x, 1, b, n_sm)
    vec = 4 if (w // tiles_x) % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    _kernels.launch(
        "clahe_pallas_hist", x.data_ptr(), lab.data_ptr(), hist.data_ptr(), degamma_table_k16(str(x.device)).data_ptr(),
        b, h, w, tiles_y, tiles_x, strips, rows, vec, stream,
    )
    LAUNCHES["clahe_pallas_hist"] += 1
    return lab, hist


# ---------------------------------------------------------------- K16, apply half


def _blend_weights(cell: int, device) -> torch.Tensor:
    """[2, cell] f32 weights by (cell parity, offset u): u / (2*cell) + 0.5
    for even cells, u / (2*cell) for odd ones, the division by the constant
    run as a multiply by its reciprocal."""
    u = torch.arange(cell, dtype=torch.float32, device=device)
    w = u * _rc(2.0 * cell)
    return torch.stack([w + 0.5, w])


def _blend(l00, l01, l10, l11, xa, ya) -> torch.Tensor:
    """K16's bilinear blend of the four neighbour LUT values, rounded to the
    new L: top = l00 (1 - xa) + l01 xa, bot = l10 (1 - xa) + l11 xa, then
    top (1 - ya) + bot ya, each sum one fused multiply-add over the other
    (separately rounded) product, in the order the JAX function's compiled
    program fuses them; the CUDA kernel makes the same three fmaf calls."""
    top = _fma(l01, xa, l00 * (1.0 - xa))
    bot = _fma(l11, xa, l10 * (1.0 - xa))
    return torch.clamp(torch.round(_fma(top, 1.0 - ya, bot * ya)), 0.0, 255.0)


def clahe_pallas_apply_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K16's second kernel: planar u8 Lab [B,3,H,W] + u8
    LUTs [B, tiles_y, tiles_x, 256] -> f32 NHWC RGB [B,H,W,3]."""
    b, _, h, w = lab.shape
    _, tiles_y, tiles_x, _ = luts.shape
    dev = lab.device
    hh, hw = h // (2 * tiles_y), w // (2 * tiles_x)

    def maps(n, tiles, cell):
        c = np.arange(n) // cell
        t0, t1 = _neighbor_index_tables(tiles)
        wt = _blend_weights(cell, dev)[torch.as_tensor(c % 2, device=dev), torch.as_tensor(np.arange(n) % cell, device=dev)]
        return torch.as_tensor(t0[c], device=dev), torch.as_tensor(t1[c], device=dev), wt

    t0y, t1y, ya = maps(h, tiles_y, hh)
    t0x, t1x, xa = maps(w, tiles_x, hw)
    luts_flat = luts.reshape(b, -1).long()
    v = lab[:, 0].long()

    def lut_at(ty, tx):
        idx = ((ty[:, None] * tiles_x + tx[None, :]) * HIST_SIZE)[None] + v
        return torch.gather(luts_flat, 1, idx.reshape(b, -1)).reshape(b, h, w).float()

    L2 = _blend(lut_at(t0y, t0x), lut_at(t0y, t1x), lut_at(t1y, t0x), lut_at(t1y, t1x), xa[None, None, :], ya[None, :, None])
    rgb = _lab_u8scale_to_rgb(L2, lab[:, 1].float(), lab[:, 2].float())
    return torch.stack([torch.round(ch * 255.0) * _rc(255.0) for ch in rgb], dim=-1)


def clahe_pallas_apply(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K16, second kernel: planar u8 Lab [B,3,H,W] + u8 LUTs [B, tiles_y,
    tiles_x, 256] -> f32 NHWC RGB [B,H,W,3] at k/255."""
    cg._check_apply(lab, luts, "clahe_pallas_apply")
    if lab.device.type == "cpu":
        return clahe_pallas_apply_plain(lab, luts)
    b, _, h, w = lab.shape
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=lab.device)
    if b * h * w == 0:
        return out
    stream = _kernels.stream(lab)
    vec = cg._apply_width(lab, w, tiles_x, 4)
    n_sm = torch.cuda.get_device_properties(lab.device).multi_processor_count
    rows, rows_par = cg.apply_plan(h, w, tiles_y, b, vec, n_sm)
    _kernels.launch(
        "clahe_pallas_apply", lab.data_ptr(), luts.data_ptr(), apply_table_block_k16(str(lab.device)).data_ptr(),
        out.data_ptr(), b, h, w, tiles_y, tiles_x, vec, rows, rows_par, stream,
    )
    LAUNCHES["clahe_pallas_apply"] += 1
    return out


# ---------------------------------------------------------------- the op


def _luts(hist: torch.Tensor, clip_limit: float, h: int, w: int, tiles_y: int, tiles_x: int) -> torch.Tensor:
    """u8 LUTs [B, tiles_y, tiles_x, 256] from the tile histograms."""
    area = (h // tiles_y) * (w // tiles_x)
    return _luts_from_hist(hist, clip_limit, area).to(torch.uint8)


def clahe_lab_rgb_pallas_plain(
    x: torch.Tensor, clip_limit: float = 2.0, tiles_x: int = 8, tiles_y: int = 8
) -> torch.Tensor:
    """Plain version of ``clahe_lab_rgb_pallas``, on any device."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _check_rgb(x, tiles_y, tiles_x, "clahe_lab_rgb_pallas_plain")
    lab, hist = clahe_pallas_hist_plain(x, tiles_y, tiles_x)
    out = clahe_pallas_apply_plain(lab, _luts(hist, clip_limit, x.shape[1], x.shape[2], tiles_y, tiles_x))
    return out[0] if squeeze else out


def clahe_lab_rgb_pallas(
    x: torch.Tensor, clip_limit: float = 2.0, tiles_x: int = 8, tiles_y: int = 8
) -> torch.Tensor:
    """Fused Lab-CLAHE. x: f32 NHWC (or HWC) RGB in [0,1], H a multiple of
    2*tiles_y and W of 2*tiles_x (else ValueError). Returns the same shape,
    values k/255. A CPU tensor runs the plain version; a CUDA tensor runs
    K16's two kernels with the LUT build between them."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _check_rgb(x, tiles_y, tiles_x, "clahe_lab_rgb_pallas")
    if x.device.type == "cpu":
        out = clahe_lab_rgb_pallas_plain(x, clip_limit, tiles_x, tiles_y)
    else:
        lab, hist = clahe_pallas_hist(x.contiguous(), tiles_y, tiles_x)
        out = clahe_pallas_apply(lab, _luts(hist, clip_limit, x.shape[1], x.shape[2], tiles_y, tiles_x))
    return out[0] if squeeze else out
