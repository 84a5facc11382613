"""Plain reference of the Lab-CLAHE that follows the net on the default
route, frozen for the benchmark.

OpenCV's 8-bit semantics (``cv2.cvtColor(RGB2LAB)``, ``createCLAHE(2.0,
(8, 8)).apply(L)``, ``cvtColor(LAB2RGB)``) with the arithmetic the JAX
package specifies for them: every float operation is an IEEE float32
operation, computed here in float64 and rounded once to float32 (``_r``),
which gives the correctly rounded float32 result on any device; the
CLAHE blend's and the tile coordinate's multiply-adds are fused (one
rounding). Tiles are padded reflect-101 on the bottom and right where the
frame does not divide into them.

Input: float [0, 1] NHWC (the net's enhanced image). Output: uint8 NHWC.
"""

from __future__ import annotations

import numpy as np
import torch

RGB2XYZ = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169), (0.019334, 0.119193, 0.950227))
XYZ2RGB = ((3.240479, -1.537150, -0.498535), (-0.969256, 1.875992, 0.041556), (0.055648, -0.204043, 1.057311))
XN, ZN = 0.950456, 1.088754
BINS = 256


def _c(v: float) -> float:
    """A constant as the float32 number it becomes."""
    return float(np.float32(v))


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round a float64 result to float32, kept in float64."""
    return t.float().double()


def _mul(a, b):
    return _r(a * b)


def _add(a, b):
    return _r(a + b)


def _sub(a, b):
    return _r(a - b)


def _div(a, b):
    return _r(a / b)


def _fma(a, b, c):
    return _r(a * b + c)


def degamma_table(device) -> torch.Tensor:
    """srgb_to_linear(v / 255) of each byte, float32 operations (its power
    as float32 arithmetic on the host's CPU), float64 holder."""
    v = torch.arange(256, dtype=torch.float32) / 255.0
    lin = torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    return lin.double().to(device)


def _cbrt(t):
    return _r(torch.pow(t, 1.0 / 3.0))


def _lab_f(t):
    lin = _add(_mul(t, _c(7.787)), _c(16.0 / 116.0))
    return torch.where(t > _c(0.008856), _cbrt(torch.clamp(t, min=_c(1e-12))), lin)


def rgb_bytes_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] sRGB -> uint8 [..., 3] Lab (OpenCV 8-bit scale)."""
    tab = degamma_table(rgb.device)
    r, g, b = (tab[rgb[..., i].long()] for i in range(3))

    def dot(m):
        return _add(_add(_mul(r, _c(m[0])), _mul(g, _c(m[1]))), _mul(b, _c(m[2])))

    x = _div(dot(RGB2XYZ[0]), _c(XN))
    y = dot(RGB2XYZ[1])
    z = _div(dot(RGB2XYZ[2]), _c(ZN))
    fx, fy, fz = _lab_f(x), _lab_f(y), _lab_f(z)
    lum = _mul(_sub(_mul(fy, _c(116.0)), _c(16.0)), _c(255.0 / 100.0))
    a = _add(_mul(_sub(fx, fy), _c(500.0)), _c(128.0))
    bb = _add(_mul(_sub(fy, fz), _c(200.0)), _c(128.0))
    return torch.stack([torch.clamp(torch.round(ch), 0, 255) for ch in (lum, a, bb)], dim=-1).to(torch.uint8)


def _f_inv(ft):
    cube = _mul(_mul(ft, ft), ft)
    return torch.where(ft > _c(6.0 / 29.0), cube, _div(_sub(ft, _c(16.0 / 116.0)), _c(7.787)))


def lab_to_rgb_bytes(lum: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lab (OpenCV 8-bit scale, float64 holders of integers) -> uint8 sRGB [..., 3]."""
    fy = _div(_add(_mul(lum, _c(100.0 / 255.0)), _c(16.0)), _c(116.0))
    fx = _add(fy, _div(_sub(a, _c(128.0)), _c(500.0)))
    fz = _sub(fy, _div(_sub(b, _c(128.0)), _c(200.0)))
    yy = _f_inv(fy)
    xx = _mul(_f_inv(fx), _c(XN))
    zz = _mul(_f_inv(fz), _c(ZN))
    out = []
    for m in XYZ2RGB:
        lin = torch.clamp(_add(_add(_mul(xx, _c(m[0])), _mul(yy, _c(m[1]))), _mul(zz, _c(m[2]))), min=0.0)
        gam = _sub(_mul(_r(torch.pow(lin, _c(1.0 / 2.4))), _c(1.055)), _c(0.055))
        s = torch.clamp(torch.where(lin <= _c(0.0031308), _mul(lin, _c(12.92)), gam), 0.0, 1.0)
        out.append(torch.clamp(torch.round(_mul(s, 255.0)), 0, 255))
    return torch.stack(out, dim=-1).to(torch.uint8)


def _reflect101(n: int, pad: int) -> np.ndarray:
    idx = np.arange(n + pad)
    return np.where(idx < n, idx, 2 * (n - 1) - idx)


def clahe(lum: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8) -> torch.Tensor:
    """CLAHE of uint8 [B, H, W] -> uint8 [B, H, W]."""
    bsz, h, w = lum.shape
    dev = lum.device
    pad_h, pad_w = (-h) % tiles, (-w) % tiles
    th, tw = (h + pad_h) // tiles, (w + pad_w) // tiles
    area = th * tw
    rows = torch.as_tensor(_reflect101(h, pad_h), device=dev)
    cols = torch.as_tensor(_reflect101(w, pad_w), device=dev)
    padded = lum.long().index_select(1, rows).index_select(2, cols)
    cells = padded.reshape(bsz, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4).reshape(bsz * tiles * tiles, area)
    offs = torch.arange(cells.shape[0], device=dev)[:, None] * BINS
    hist = torch.bincount((cells + offs).reshape(-1), minlength=cells.shape[0] * BINS).reshape(-1, BINS)
    clip = max(int(clip_limit * area / BINS), 1)
    clipped = torch.clamp(hist, max=clip)
    excess = (hist - clipped).sum(dim=1, keepdim=True)
    redist = excess // BINS
    residual = excess - redist * BINS
    step = torch.clamp(BINS // torch.clamp(residual, min=1), min=1)
    bins = torch.arange(BINS, device=dev)
    hist = clipped + redist + ((bins % step == 0) & (bins // step < residual)).long()
    cdf = torch.cumsum(hist, dim=1).double()
    lut = torch.clamp(torch.round(_mul(cdf, _c(255.0 / area))), 0, 255).long().reshape(bsz, tiles * tiles * BINS)

    def coord(n, tile):
        i = torch.arange(n, dtype=torch.float64, device=dev)
        t = _fma(i, _c(1.0 / tile), -0.5)
        t0 = torch.floor(t)
        return t0.long(), _sub(t, t0)

    y0, ya = coord(h, th)
    x0, xa = coord(w, tw)
    y0i, y1i = torch.clamp(y0, 0, tiles - 1), torch.clamp(y0 + 1, 0, tiles - 1)
    x0i, x1i = torch.clamp(x0, 0, tiles - 1), torch.clamp(x0 + 1, 0, tiles - 1)
    v = lum.long()

    def at(yi, xi):
        idx = ((yi[:, None] * tiles + xi[None, :]) * BINS)[None] + v
        return torch.gather(lut, 1, idx.reshape(bsz, -1)).reshape(bsz, h, w).double()

    ya2, xa2 = ya[None, :, None], xa[None, None, :]
    top = _fma(at(y0i, x0i), _sub(1.0, xa2), _mul(at(y0i, x1i), xa2))
    bot = _fma(at(y1i, x0i), _sub(1.0, xa2), _mul(at(y1i, x1i), xa2))
    return torch.clamp(torch.round(_fma(top, _sub(1.0, ya2), _mul(bot, ya2))), 0, 255).to(torch.uint8)


def lab_clahe(x: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8) -> torch.Tensor:
    """float [0, 1] NHWC -> uint8 NHWC: bytes, Lab, CLAHE on L, back to sRGB."""
    rgb = torch.round(_mul(torch.clamp(x.double(), 0.0, 1.0), 255.0)).to(torch.uint8)
    lab = rgb_bytes_to_lab(rgb)
    lum = clahe(lab[..., 0], clip_limit, tiles)
    return lab_to_rgb_bytes(lum.double(), lab[..., 1].double(), lab[..., 2].double())
