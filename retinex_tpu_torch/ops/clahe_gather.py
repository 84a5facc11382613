"""Lab-CLAHE on CUDA kernels, with their plain PyTorch versions.

Counterpart of ``retinex_tpu/ops/clahe_gather.py``: its float pipeline
(``clahe_lab_rgb_gather``), which every net route and single-image
``--classical_mode clahe`` run, its planar u8 pipeline
(``clahe_rgb_u8_planar_gather5``) and its NHWC u8 entry
(``clahe_rgb_u8_gather``), which directory batches in ``clahe`` mode run.
The kernels live in ``retinex_tpu_torch/csrc/clahe_lab.cu``, three kernels
in several instances:

- ``lab_fwd_u8`` (K1): planar u8 sRGB [B,3,H,W] -> planar u8 OpenCV Lab;
- ``lab_fwd_f32_nhwc`` (K1 on the float input): float [B,H,W,3] in [0,1]
  -> the same planar Lab, the quantisation rint(clamp(x,0,1)*255) folded
  into the kernel's reads;
- ``lab_fwd_u8_nhwc`` (K8, forward half): u8 NHWC sRGB [B,H,W,3] -> the
  same planar Lab, the transpose folded into the kernel's reads;
- ``clahe_tables`` (K2): per-tile histograms of a u8 plane (the L plane of
  planar Lab, or a [B,H,W] luma plane for ``ops/clahe_luma.py``) with the
  within-cell ``hist_subsample`` decimation, OpenCV clip/redistribute, CDF
  and LUT, as u8 [B, tiles_y, tiles_x, 256]; each tile's rows are spread
  over several blocks (``tables_plan``);
- ``clahe_apply_u8`` (K3): 4-neighbour LUT blend on L, then Lab -> planar
  sRGB u8, from tables built once per process (``apply_tables``);
- ``clahe_apply_f32_nhwc`` (K3 writing the float image): the same bytes as
  float v / 255, NHWC;
- ``clahe_apply_u8_nhwc`` (K8, apply half): the same, written as u8 NHWC;
- ``clahe_tables_tiles`` (K2 in its tile-row mode) and
  ``clahe_apply_tiles_f32_nhwc`` (K3 in its tile-coordinate mode): the same
  pipeline on a frame of any shape with ``clahe.clahe_u8``'s semantics (the
  tiles of the reflect-101 padded frame, each pixel's tile coordinate), for
  ``clahe.clahe_lab_rgb`` on the card where the frame is not cell-divisible.

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
from retinex_tpu_torch.ops.clahe import (
    HIST_SIZE,
    _interp_maps,
    _luts_from_hist,
    blend_tiles,
    cell_divisible,
    padded_tile_hist,
    tile_dims,
)
from retinex_tpu_torch.ops.clahe_fast import _hist_from_cells, apply_from_cells
from retinex_tpu_torch.ops.colorspace import (
    _lab_f_inv,
    degamma_table,
    ieee_div,
    lab8_da,
    lab8_db,
    lab8_fy,
    lab8_to_linear_rgb,
    linear_to_srgb,
    srgb_bytes_to_lab_u8,
)

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {
    "lab_fwd_u8": 0,
    "lab_fwd_f32_nhwc": 0,
    "lab_fwd_u8_nhwc": 0,
    "clahe_tables": 0,
    "clahe_apply_u8": 0,
    "clahe_apply_f32_nhwc": 0,
    "clahe_apply_u8_nhwc": 0,
    "clahe_tables_tiles": 0,
    "clahe_apply_tiles_f32_nhwc": 0,
}

# The sRGB side's layouts, numbered as csrc/clahe_lab.cu's Layout:
# planar u8, NHWC u8, float [B,H,W,3] stored channels first, NHWC float.
_U8_PLANAR, _U8_NHWC, _F32_PLANAR, _F32_NHWC = range(4)


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


# ---------------------------------------------------------------- K1


def _fwd_width(ptr: int, plane: int, f32: bool) -> int:
    """Pixels a K1 thread takes: 4 where the plane and the input's address
    allow its wide loads (16-byte vectors of floats, 4-byte words of
    bytes), else 1."""
    return 4 if plane % 4 == 0 and ptr % (16 if f32 else 4) == 0 else 1


def _launch_fwd(src: torch.Tensor, layout: int, b: int, h: int, w: int, name: str) -> torch.Tensor:
    """Planar u8 Lab [b,3,h,w] of `src` in `layout`, by K1's kernel."""
    out = torch.empty((b, 3, h, w), dtype=torch.uint8, device=src.device)
    if b * h * w == 0:
        return out
    stream = _kernels.stream(src)
    vec = _fwd_width(src.data_ptr(), h * w, layout >= _F32_PLANAR)
    tab = degamma_table(str(src.device))
    _kernels.launch("clahe_lab_fwd", src.data_ptr(), out.data_ptr(), tab.data_ptr(), b, h * w, layout, vec, stream)
    LAUNCHES[name] += 1
    return out


def lab_fwd_u8_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: planar u8 sRGB -> planar u8 8-bit Lab."""
    return srgb_bytes_to_lab_u8(rgb, 1)


def lab_fwd_u8(rgb: torch.Tensor) -> torch.Tensor:
    """K1: planar u8 sRGB [B,3,H,W] -> planar u8 OpenCV 8-bit Lab."""
    _check_planar_u8(rgb, "lab_fwd_u8")
    if rgb.device.type == "cpu":
        return lab_fwd_u8_plain(rgb)
    b, _, h, w = rgb.shape
    return _launch_fwd(rgb, _U8_PLANAR, b, h, w, "lab_fwd_u8")


def quantise_planar_u8(x: torch.Tensor) -> torch.Tensor:
    """Float [B,H,W,3] -> planar u8 [B,3,H,W]: rint(clamp(x, 0, 1) * 255),
    the JAX package's glue before K1 (half to even, as K1's float instance
    rounds)."""
    xp = x.permute(0, 3, 1, 2)
    return torch.clamp(torch.round(torch.clamp(xp, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8).contiguous()


def lab_fwd_f32_nhwc_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's float instance: the quantisation, then K1's."""
    return lab_fwd_u8_plain(quantise_planar_u8(x))


def _planar_lab_like(x: torch.Tensor) -> torch.Tensor:
    """Fake implementation of K1's float instance: planar u8 [B,3,H,W] of
    float [B,H,W,3]."""
    return x.new_empty((x.shape[0], 3, x.shape[1], x.shape[2]), dtype=torch.uint8)


@_kernels.operator("lab_fwd_f32_nhwc", _planar_lab_like)
def lab_fwd_f32_nhwc(x: torch.Tensor) -> torch.Tensor:
    """K1 on the float input: f32 [B,H,W,3] in [0,1] -> planar u8 Lab
    [B,3,H,W], quantised as ``quantise_planar_u8`` in the kernel's reads.

    x's memory may be NHWC or channels first (the nets' NHWC outputs are
    permuted NCHW tensors); either is read in place."""
    if x.dtype != torch.float32 or x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"lab_fwd_f32_nhwc: expected float32 [B, H, W, 3], got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lab_fwd_f32_nhwc_plain(x)
    if x.is_contiguous():
        layout = _F32_NHWC
    elif x.permute(0, 3, 1, 2).is_contiguous():
        layout = _F32_PLANAR
    else:
        x, layout = x.contiguous(), _F32_NHWC
    b, h, w, _ = x.shape
    return _launch_fwd(x, layout, b, h, w, "lab_fwd_f32_nhwc")


def lab_fwd_u8_nhwc_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's forward half: K1's on the permuted batch."""
    return lab_fwd_u8_plain(rgb.permute(0, 3, 1, 2).contiguous())


def lab_fwd_u8_nhwc(rgb: torch.Tensor) -> torch.Tensor:
    """K8, forward half: u8 NHWC sRGB [B,H,W,3] -> planar u8 Lab [B,3,H,W]."""
    _check_nhwc_u8(rgb, "lab_fwd_u8_nhwc")
    if rgb.device.type == "cpu":
        return lab_fwd_u8_nhwc_plain(rgb)
    b, h, w, _ = rgb.shape
    return _launch_fwd(rgb, _U8_NHWC, b, h, w, "lab_fwd_u8_nhwc")


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
    return strip_plan(2 * (-(-hh // hist_subsample)), tiles_y * tiles_x, batch, n_sm)


def strip_plan(n_rows: int, n_tiles: int, batch: int, n_sm: int = 132) -> tuple[int, int]:
    """(strips per tile, rows per strip): a tile's `n_rows` rows cut into
    strips so that the grid of n_tiles * strips blocks per image holds about
    K2_BLOCKS_PER_SM blocks per SM, every strip at least one row."""
    want = -(-K2_BLOCKS_PER_SM * n_sm // (batch * n_tiles))
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


def _load_width(plane: torch.Tensor, img_stride: int, w: int, tiles_x: int, tile_w: int | None = None) -> int:
    """Bytes a K2 thread loads at once: 16, else 4, else 1, as the plane's
    address, the image stride, the row stride and the tile width (w //
    tiles_x, or the padded tile's `tile_w`) allow."""
    tile_w = w // tiles_x if tile_w is None else tile_w
    for v in (16, 4):
        if plane.data_ptr() % v == 0 and img_stride % v == 0 and w % v == 0 and tile_w % v == 0:
            return v
    return 1


def _luts_like(src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8,
               hist_subsample: int = 1) -> torch.Tensor:
    """Fake implementation of K2: u8 LUTs [B, tiles_y, tiles_x, 256]."""
    return src.new_empty((src.shape[0], tiles_y, tiles_x, HIST_SIZE), dtype=torch.uint8)


@_kernels.operator("clahe_tables", _luts_like)
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
    tile_h, tile_w = h // tiles_y, w // tiles_x
    _kernels.launch(
        "clahe_tables", src.data_ptr(), out.data_ptr(), scratch.data_ptr(), img_stride, b, h, w, tiles_y, tiles_x,
        tile_h, tile_w, 0, hist_subsample, clip, float(lut_scale), strips, rows,
        _load_width(plane, img_stride, w, tiles_x), stream,
    )
    LAUNCHES["clahe_tables"] += 1
    return out


# ---------------------------------------------------------------- K3

# K3's sRGB quantiser: one bucket per 2**16 f32 bit patterns (sign, exponent
# and the top 7 mantissa bits), from the bucket of 2**-13 (below which every
# lin gives byte 0) to the bucket of 1.0 (above which every lin gives 255);
# csrc/clahe_lab.cu's kQuantBase and kQuantLast.
QUANT_BASE = (127 - 13) << 7
QUANT_LAST = (127 << 7) - QUANT_BASE
# K3's table block in 32-bit words (csrc/clahe_lab.cu kTab*): fy and Y by L
# (interleaved), (a-128)/500, (b-128)/200, the quantiser's buckets.
_TAB_QUANT = 1024
APPLY_TABLE_WORDS = (_TAB_QUANT + QUANT_LAST + 1 + 3) // 4 * 4
# Hopper's largest shared memory for one block, which K3 opts into where its
# tables, neighbour words and store staging need more than 48 KB.
_SMEM_MAX = 227 * 1024
# K3's blocks: K3_ROWS_PAR rows of 256 threads, each walking a band of
# rows, the bands as short as lets the grid hold at most K3_BLOCKS_PER_SM
# blocks per SM (one wave: a block's staging is paid once per block, and a
# second wave would leave most SMs idle behind a few).
K3_ROWS_PAR = 4
K3_BLOCKS_PER_SM = 1
_APPLY_THREADS = 256
# K3's store staging at most: the float output, 4 pixels a thread, 12 words a lane.
_K3_STAGE_BYTES = _APPLY_THREADS * K3_ROWS_PAR * 12 * 4


def srgb_byte_plain(lin: torch.Tensor) -> torch.Tensor:
    """The output byte of linear light, as float: rint(clamp(sRGB(lin), 0, 1) * 255)."""
    return torch.round(torch.clamp(linear_to_srgb(lin), 0.0, 1.0) * 255.0)


def srgb_byte_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """``srgb_byte_plain`` of f32 bit patterns, each evaluated as the plain
    version evaluates a plane's pixels. PyTorch's CPU pow runs on vectors of
    32 floats (or 16) and gives a tensor's last len % 32 elements to a
    scalar pow, which can round the other way; so the patterns are padded
    to whole vectors."""
    n = bits.numel()
    padded = torch.cat([bits, bits[-1:].expand((-n) % 32)]).to(torch.int32)
    return srgb_byte_plain(padded.view(torch.float32))[:n]


@functools.lru_cache(maxsize=None)
def srgb_thresholds() -> torch.Tensor:
    """int64 [257]: T[k] is the bit pattern of the least non-negative f32
    whose ``srgb_byte_plain`` is at least k (T[0] = 0, T[256] past every
    f32), found by bisection over the bit patterns of [0, 1.0]
    (``srgb_byte_of_bits``). The bisection takes the byte to be
    non-decreasing in lin, which tests/test_torch_clahe_lab_exact.py
    checks over every f32 where it steps."""
    one = int(torch.tensor(1.0).view(torch.int32))
    if float(srgb_byte_plain(torch.tensor(1.0))) != 255.0:
        raise RuntimeError("the sRGB quantiser does not give 255 at 1.0")
    ks = torch.arange(1, 256, dtype=torch.float32)
    lo = torch.zeros(255, dtype=torch.int64)
    hi = torch.full((255,), one, dtype=torch.int64)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        ok = srgb_byte_of_bits(mid) >= ks
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    return torch.cat([torch.zeros(1, dtype=torch.int64), lo, torch.tensor([2**31], dtype=torch.int64)])


def quant_buckets(t: torch.Tensor) -> torch.Tensor:
    """int64 [QUANT_LAST + 1]: each bucket's entry, (b0 << 17) | cmp, where
    b0 is the byte at the bucket's first bit pattern and cmp the low 16
    bits of the next step's pattern, or 0x10000 where the bucket has no
    step; raises where a bucket would need two compares."""
    start = (QUANT_BASE + torch.arange(QUANT_LAST + 1, dtype=torch.int64)) << 16
    end = start + 0xFFFF
    b0 = torch.searchsorted(t[1:256], start, right=True)
    nxt = t[b0 + 1]
    after = t[torch.clamp(b0 + 2, max=256)]
    if bool((after <= end).any()):
        raise RuntimeError("a quantiser bucket holds two steps of the sRGB byte")
    if int(b0[0]) != 0 or int(nxt[0]) <= int(end[0]) or int(b0[-1]) != 255:
        raise RuntimeError("the quantiser's first bucket must give 0 throughout and its last 255")
    cmp = torch.where(nxt <= end, nxt & 0xFFFF, torch.full_like(nxt, 0x10000))
    return (b0 << 17) | cmp


@functools.lru_cache(maxsize=None)
def apply_tables() -> dict[str, torch.Tensor]:
    """K3's tables on the CPU, each by the plain version's own f32
    operations: fy and Y = f^-1(fy) by L, (a - 128)/500 by a, (b - 128)/200
    by b, and the quantiser's buckets (int64)."""
    v = torch.arange(HIST_SIZE, dtype=torch.float32)
    fy = lab8_fy(v)
    return {
        "fy": fy, "y": _lab_f_inv(fy), "da": lab8_da(v), "db": lab8_db(v),
        "quant": quant_buckets(srgb_thresholds()),
    }


def table_words(t: dict[str, torch.Tensor]) -> torch.Tensor:
    """int32 [APPLY_TABLE_WORDS]: tables as K3 stages them (``apply_tables``'s
    keys; da and db may be absent, as K16's apply reads none), after
    checking that csrc/clahe_lab.cu lays them out so."""
    layout = tuple(_kernels.query("clahe_apply_table_layout", i) for i in range(3))
    if layout != (QUANT_BASE, QUANT_LAST, APPLY_TABLE_WORDS):
        raise RuntimeError(f"csrc/clahe_lab.cu lays out K3's tables as {layout}, this module as "
                           f"{(QUANT_BASE, QUANT_LAST, APPLY_TABLE_WORDS)}")
    words = torch.zeros(APPLY_TABLE_WORDS, dtype=torch.int32)
    words[:512] = torch.stack([t["fy"], t["y"]], dim=1).reshape(-1).view(torch.int32)
    if "da" in t:
        words[512:768] = t["da"].view(torch.int32)
        words[768:1024] = t["db"].view(torch.int32)
    words[_TAB_QUANT : _TAB_QUANT + QUANT_LAST + 1] = t["quant"].to(torch.int32)
    return words


@functools.lru_cache(maxsize=None)
def _apply_table_block(device: str) -> torch.Tensor:
    """int32 [APPLY_TABLE_WORDS]: ``apply_tables`` laid out as K3 stages them."""
    return table_words(apply_tables()).to(device)


def dequantise_nhwc(u8: torch.Tensor) -> torch.Tensor:
    """Planar u8 [B,3,H,W] -> float [B,H,W,3], each byte / 255 as IEEE
    division rounds it on every device (``ieee_div``; the JAX package's
    glue, and PyTorch's on the CPU)."""
    return ieee_div(u8.permute(0, 2, 3, 1).float(), 255.0)


def clahe_apply_u8_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: LUT blend on L, a/b through, Lab -> planar u8 sRGB."""
    L2 = apply_from_cells(lab[:, 0], luts).to(torch.float32)
    rgb = lab8_to_linear_rgb(L2, lab[:, 1].float(), lab[:, 2].float())
    return torch.stack([srgb_byte_plain(ch) for ch in rgb], dim=1).to(torch.uint8)


def _check_luts(
    luts: torch.Tensor, b: int, h: int, w: int, device: torch.device, what: str, smem_fixed: int = 0,
    smem_per_tile: int = 2 * HIST_SIZE, smem_max: int = 48 * 1024, cells: bool = True,
) -> tuple[int, int]:
    """Validate u8 LUTs [b, ty, tx, 256] for an h x w frame (cell-divisible
    unless `cells` is False); return (ty, tx). On the card the kernel stages
    `smem_fixed` bytes and `smem_per_tile` for each x-tile (two tile rows of
    LUTs, by default) in at most `smem_max` bytes of shared memory."""
    if luts.dtype != torch.uint8 or luts.ndim != 4 or luts.shape[0] != b or luts.shape[3] != HIST_SIZE:
        raise ValueError(f"{what}: expected uint8 LUTs [{b}, ty, tx, 256], got {luts.dtype} {tuple(luts.shape)}")
    if not luts.is_contiguous() or luts.device != device:
        raise ValueError(f"{what}: LUTs must be contiguous and on the image's device")
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    if cells:
        _check_cells(h, w, tiles_y, tiles_x)
    if device.type != "cpu" and smem_fixed + smem_per_tile * tiles_x > smem_max:
        raise ValueError(f"{what}: tiles_x={tiles_x} needs more than {smem_max // 1024} KB of shared memory")
    return tiles_y, tiles_x


def _apply_width(lab: torch.Tensor, w: int, tiles_x: int, widest: int) -> int:
    """Pixels a K3 thread takes: `widest` (8 for bytes out, 4 for floats,
    whose 3 * 8 interleaved values a thread stores slower), else 4, where
    the cell width is a multiple (so the group lies in one cell) and the
    Lab planes are aligned to it; else 1."""
    for v in (widest, 4):
        if (w // (2 * tiles_x)) % v == 0 and lab.data_ptr() % v == 0:
            return v
    return 1


def apply_plan(h: int, w: int, tiles_y: int, batch: int, vec: int, n_sm: int = 132) -> tuple[int, int]:
    """(rows of one half-tile cell row that a K3 block walks, rows it takes
    at once): the most bands per cell row with which the grid stays within
    K3_BLOCKS_PER_SM blocks per SM (one band where even that is too many),
    K3_ROWS_PAR rows at once (fewer in a shorter band)."""
    hh = h // (2 * tiles_y)
    col_blocks = -(-(w // vec) // _APPLY_THREADS)
    bands = max(1, K3_BLOCKS_PER_SM * n_sm // (col_blocks * 2 * tiles_y * batch))
    rows = -(-hh // min(bands, hh))
    return rows, min(K3_ROWS_PAR, rows)


def _launch_apply(lab: torch.Tensor, luts: torch.Tensor, out: torch.Tensor, layout: int, name: str) -> torch.Tensor:
    """K3's kernel on planar u8 Lab and its LUTs, into `out` in `layout`."""
    b, _, h, w = lab.shape
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    if b * h * w == 0:
        return out
    stream = _kernels.stream(lab)
    vec = _apply_width(lab, w, tiles_x, 4 if layout == _F32_NHWC else 8)
    n_sm = torch.cuda.get_device_properties(lab.device).multi_processor_count
    rows, rows_par = apply_plan(h, w, tiles_y, b, vec, n_sm)
    tables = _apply_table_block(str(lab.device))
    _kernels.launch(
        "clahe_apply", lab.data_ptr(), luts.data_ptr(), tables.data_ptr(), out.data_ptr(), b, h, w, tiles_y, tiles_x,
        layout, vec, rows, rows_par, stream,
    )
    LAUNCHES[name] += 1
    return out


def _check_apply(lab: torch.Tensor, luts: torch.Tensor, what: str, cells: bool = True) -> None:
    _check_planar_u8(lab, what)
    b, _, h, w = lab.shape
    fixed = 4 * (APPLY_TABLE_WORDS + HIST_SIZE) + _K3_STAGE_BYTES
    _check_luts(luts, b, h, w, lab.device, what, fixed, 4 * HIST_SIZE, _SMEM_MAX, cells)


def clahe_apply_u8(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K3: planar u8 Lab + u8 LUTs [B, tiles_y, tiles_x, 256] -> planar u8 sRGB."""
    _check_apply(lab, luts, "clahe_apply_u8")
    if lab.device.type == "cpu":
        return clahe_apply_u8_plain(lab, luts)
    return _launch_apply(lab, luts, torch.empty_like(lab), _U8_PLANAR, "clahe_apply_u8")


def clahe_apply_f32_nhwc_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's float instance: K3's bytes / 255, as [B,H,W,3]."""
    return dequantise_nhwc(clahe_apply_u8_plain(lab, luts))


def _rgb_f32_like(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Fake implementation of K3's float instances: f32 [B,H,W,3] of planar
    Lab [B,3,H,W]."""
    return lab.new_empty((lab.shape[0], lab.shape[2], lab.shape[3], 3), dtype=torch.float32)


@_kernels.operator("clahe_apply_f32_nhwc", _rgb_f32_like)
def clahe_apply_f32_nhwc(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K3 writing the float image: planar u8 Lab + u8 LUTs -> f32 NHWC
    [B,H,W,3], each value the output byte / 255 (contiguous on either
    device, as the operator's fake implementation says)."""
    _check_apply(lab, luts, "clahe_apply_f32_nhwc")
    if lab.device.type == "cpu":
        return clahe_apply_f32_nhwc_plain(lab, luts).contiguous()
    b, _, h, w = lab.shape
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=lab.device)
    return _launch_apply(lab, luts, out, _F32_NHWC, "clahe_apply_f32_nhwc")


def clahe_apply_u8_nhwc_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's apply half: K3's, permuted to NHWC."""
    return clahe_apply_u8_plain(lab, luts).permute(0, 2, 3, 1).contiguous()


def clahe_apply_u8_nhwc(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K8, apply half: planar u8 Lab + u8 LUTs -> u8 NHWC sRGB [B,H,W,3]."""
    _check_apply(lab, luts, "clahe_apply_u8_nhwc")
    if lab.device.type == "cpu":
        return clahe_apply_u8_nhwc_plain(lab, luts)
    b, _, h, w = lab.shape
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=lab.device)
    return _launch_apply(lab, luts, out, _U8_NHWC, "clahe_apply_u8_nhwc")


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
    """Float Lab-CLAHE: x float [0,1] NHWC/HWC (taken as float32, as the JAX
    package computes) -> float32 of the same shape, K1 -> K2 -> K3 in their
    float instances: the quantisation to u8 and the division by 255 run
    inside the kernels, as the JAX package's XLA glue runs around them."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _check_cells(x.shape[1], x.shape[2], tiles_y, tiles_x)
    lab = lab_fwd_f32_nhwc(x.to(torch.float32))
    luts = clahe_tables(lab, clip_limit, tiles_y, tiles_x, hist_subsample)
    out = clahe_apply_f32_nhwc(lab, luts)
    return out[0] if squeeze else out


# ---------------------------------------------------------------- K2 and K3 on any frame (G1)


def _check_reflect(h: int, w: int, tiles_y: int, tiles_x: int) -> None:
    """Reflect-101 padding to whole tiles reaches back at most H - 1 rows and
    W - 1 columns (``clahe.clahe_u8`` fails on smaller frames too)."""
    pad_h, pad_w, _, _ = tile_dims(h, w, tiles_y, tiles_x)
    if pad_h > h - 1 or pad_w > w - 1:
        raise ValueError(f"shape {(h, w)} is too small to pad to {tiles_y}x{tiles_x} tiles by reflect-101")


def clahe_tables_tiles_plain(src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8) -> torch.Tensor:
    """Plain version of K2's tile-row mode: the histograms of the reflect-101
    padded tiles (``clahe.padded_tile_hist``), then ``_luts_from_hist``, as
    u8 LUTs [B, tiles_y, tiles_x, 256]."""
    plane, _ = _plane(src, "clahe_tables_tiles_plain")
    hist, area = padded_tile_hist(plane, tiles_y, tiles_x)
    return _luts_from_hist(hist, clip_limit, area).to(torch.uint8)


def _tile_luts_like(src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8) -> torch.Tensor:
    """Fake implementation of K2's tile-row mode: u8 LUTs [B, tiles_y, tiles_x, 256]."""
    return _luts_like(src, clip_limit, tiles_y, tiles_x)


@_kernels.operator("clahe_tables_tiles", _tile_luts_like)
def clahe_tables_tiles(src: torch.Tensor, clip_limit: float = 2.0, tiles_y: int = 8, tiles_x: int = 8) -> torch.Tensor:
    """K2 in its tile-row mode: the CLAHE LUT of every tile of the frame
    padded by reflect-101 to whole tiles (``clahe.clahe_u8``'s tables), from
    the L plane of planar u8 Lab [B,3,H,W] or a u8 plane [B,H,W] of any
    shape. On the card one launch, row strips of each tile over the card
    (``strip_plan``)."""
    plane, img_stride = _plane(src, "clahe_tables_tiles")
    b, h, w = plane.shape
    _check_reflect(h, w, tiles_y, tiles_x)
    if src.device.type == "cpu":
        return clahe_tables_tiles_plain(src, clip_limit, tiles_y, tiles_x)
    _, _, tile_h, tile_w = tile_dims(h, w, tiles_y, tiles_x)
    area = tile_h * tile_w
    clip = max(int(clip_limit * area / HIST_SIZE), 1)
    lut_scale = np.float32(float(HIST_SIZE - 1) / float(area))
    stream = _kernels.stream(src)
    out = torch.empty((b, tiles_y, tiles_x, HIST_SIZE), dtype=torch.uint8, device=src.device)
    if b == 0:
        return out
    n_sm = torch.cuda.get_device_properties(src.device).multi_processor_count
    strips, rows = strip_plan(tile_h, tiles_y * tiles_x, b, n_sm)
    scratch = torch.zeros(b * tiles_y * tiles_x * (HIST_SIZE + 1), dtype=torch.int32, device=src.device)
    _kernels.launch(
        "clahe_tables", src.data_ptr(), out.data_ptr(), scratch.data_ptr(), img_stride, b, h, w, tiles_y, tiles_x,
        tile_h, tile_w, 1, 1, clip, float(lut_scale), strips, rows, _load_width(plane, img_stride, w, tiles_x, tile_w),
        stream,
    )
    LAUNCHES["clahe_tables_tiles"] += 1
    return out


def row_bands(h: int, w: int, tiles_y: int, tiles_x: int) -> list[tuple[int, int, int, int]]:
    """The runs of rows that share one tile pair: [(first row, end, y0i,
    y1i)], from ``clahe._interp_maps`` on the CPU (the plain version's own
    coordinate arithmetic)."""
    _, _, tile_h, tile_w = tile_dims(h, w, tiles_y, tiles_x)
    (y0i, y1i, _), _ = _interp_maps(h, w, tiles_y, tiles_x, tile_h, tile_w)
    pairs = torch.stack([y0i, y1i], dim=1).tolist()
    runs = []
    for i, p in enumerate(pairs):
        if runs and list(runs[-1][2:]) == p:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1, *p])
    return [tuple(r) for r in runs]


def tiles_plan(runs: list, col_blocks: int, batch: int, n_sm: int = 132) -> int:
    """Rows of a K3 band in its tile-coordinate mode: the fewest with which
    the runs, each cut into bands of that many rows, make a grid of at most
    K3_BLOCKS_PER_SM blocks per SM (one band a run where even that is too
    many)."""
    budget = max(len(runs), K3_BLOCKS_PER_SM * n_sm // (col_blocks * batch))
    longest = max(r[1] - r[0] for r in runs)
    for rows in range(1, longest + 1):
        if sum(-(-(r1 - r0) // rows) for r0, r1, _, _ in runs) <= budget:
            return rows
    return longest


@functools.lru_cache(maxsize=64)
def tile_geometry(h: int, w: int, tiles_y: int, tiles_x: int, batch: int, vec: int, n_sm: int, device: str):
    """K3's tile-coordinate geometry for an h x w frame, on `device`: (int32
    block, bands, rows a block takes at once). The block holds the band
    table [bands][4] (first row, end, y0i, y1i: ``row_bands`` cut by
    ``tiles_plan``), then each row's ya [h] and each column's xa [w] as f32
    bits, then each column's x pair [w]: p with (x0i, x1i) = (max(p - 1, 0),
    min(p, tiles_x - 1)). All from ``clahe._interp_maps`` on the CPU."""
    _, _, tile_h, tile_w = tile_dims(h, w, tiles_y, tiles_x)
    (_, _, ya), (x0i, x1i, xa) = _interp_maps(h, w, tiles_y, tiles_x, tile_h, tile_w)
    pair = torch.where(x1i > x0i, x1i, torch.where(x0i == 0, 0, tiles_x))
    runs = row_bands(h, w, tiles_y, tiles_x)
    rows = tiles_plan(runs, -(-(w // vec) // _APPLY_THREADS), batch, n_sm)
    bands = [(i, min(i + rows, r1), t0, t1) for r0, r1, t0, t1 in runs for i in range(r0, r1, rows)]
    block = torch.cat([
        torch.tensor(bands, dtype=torch.int32).reshape(-1), ya.view(torch.int32), xa.view(torch.int32),
        pair.to(torch.int32),
    ])
    return block.to(device), len(bands), min(K3_ROWS_PAR, rows)


def clahe_apply_tiles_f32_nhwc_plain(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's tile-coordinate mode: clahe_u8's blend on L
    (``clahe.blend_tiles``), a/b through, K3's plain Lab -> sRGB bytes, each
    / 255, as [B,H,W,3]."""
    L2 = blend_tiles(lab[:, 0], luts).to(torch.float32)
    rgb = lab8_to_linear_rgb(L2, lab[:, 1].float(), lab[:, 2].float())
    return dequantise_nhwc(torch.stack([srgb_byte_plain(ch) for ch in rgb], dim=1).to(torch.uint8))


def _tiles_width(lab: torch.Tensor, w: int) -> int:
    """Pixels a thread of K3's tile-coordinate mode takes: 4 where the row
    width is a multiple and the Lab planes are aligned to it, else 1."""
    return 4 if w % 4 == 0 and lab.data_ptr() % 4 == 0 else 1


@_kernels.operator("clahe_apply_tiles_f32_nhwc", _rgb_f32_like)
def clahe_apply_tiles_f32_nhwc(lab: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """K3 in its tile-coordinate mode: planar u8 Lab [B,3,H,W] of any shape +
    the padded tiles' u8 LUTs [B, tiles_y, tiles_x, 256] -> f32 NHWC
    [B,H,W,3] (contiguous), each value the output byte / 255: clahe_u8's
    blend, then K3's Lab -> sRGB."""
    _check_apply(lab, luts, "clahe_apply_tiles_f32_nhwc", cells=False)
    if lab.device.type == "cpu":
        return clahe_apply_tiles_f32_nhwc_plain(lab, luts).contiguous()
    b, _, h, w = lab.shape
    tiles_y, tiles_x = luts.shape[1], luts.shape[2]
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=lab.device)
    if b * h * w == 0:
        return out
    stream = _kernels.stream(lab)
    vec = _tiles_width(lab, w)
    n_sm = torch.cuda.get_device_properties(lab.device).multi_processor_count
    geom, bands, rows_par = tile_geometry(h, w, tiles_y, tiles_x, b, vec, n_sm, str(lab.device))
    tables = _apply_table_block(str(lab.device))
    _kernels.launch(
        "clahe_apply_tiles", lab.data_ptr(), luts.data_ptr(), tables.data_ptr(), geom.data_ptr(), out.data_ptr(), b, h,
        w, tiles_y, tiles_x, bands, vec, rows_par, stream,
    )
    LAUNCHES["clahe_apply_tiles_f32_nhwc"] += 1
    return out


def clahe_lab_rgb_tiles(
    x: torch.Tensor,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
) -> torch.Tensor:
    """Float Lab-CLAHE on a frame of any shape with ``clahe.clahe_u8``'s
    semantics: x float [0,1] NHWC/HWC -> float32 of the same shape, K1 in
    its float instance -> K2 in its tile-row mode -> K3 in its
    tile-coordinate mode (``clahe.clahe_lab_rgb`` on the card where the
    frame is not cell-divisible)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    lab = lab_fwd_f32_nhwc(x.to(torch.float32))
    luts = clahe_tables_tiles(lab, clip_limit, tiles_y, tiles_x)
    out = clahe_apply_tiles_f32_nhwc(lab, luts)
    return out[0] if squeeze else out
