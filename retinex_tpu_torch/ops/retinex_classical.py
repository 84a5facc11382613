"""Classical SSR / MSR / MSRCR log-domain Retinex in PyTorch (NHWC).

Counterpart of ``retinex_tpu/ops/retinex_classical.py``: the large-sigma
Gaussians are three iterated box filters (Kovesi's widths), each box two
cumulative sums and a subtraction per axis with edge-replicated padding;
the percentile stretch takes its quantiles from a 512-bin histogram CDF.
"""

from __future__ import annotations

import math

import torch

_EPS = 1.0 / 255.0


def _box_blur_axis(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Mean filter of width 2*radius+1 along one spatial axis (1=H, 2=W) via
    cumsum, edge-replicated padding."""
    if radius <= 0:
        return x
    n = x.shape[axis]
    lo = x.narrow(axis, 0, 1).repeat_interleave(radius + 1, dim=axis)
    hi = x.narrow(axis, n - 1, 1).repeat_interleave(radius, dim=axis)
    xp = torch.cat([lo, x, hi], dim=axis)
    c = torch.cumsum(xp, dim=axis)
    w = 2 * radius + 1
    return (c.narrow(axis, w, n) - c.narrow(axis, 0, n)) / w


def _boxes_for_gauss(sigma: float, n: int = 3) -> list[int]:
    """Kovesi's box widths: n iterated boxes whose composition approximates a
    Gaussian of the given sigma. Returns per-pass radii."""
    w_ideal = math.sqrt((12.0 * sigma * sigma / n) + 1.0)
    wl = int(math.floor(w_ideal))
    if wl % 2 == 0:
        wl -= 1
    wu = wl + 2
    m_ideal = (12.0 * sigma * sigma - n * wl * wl - 4 * n * wl - 3 * n) / (-4.0 * wl - 4.0)
    m = int(round(m_ideal))
    sizes = [wl if i < m else wu for i in range(n)]
    return [(s - 1) // 2 for s in sizes]


def gaussian_blur_approx(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """3-pass box approximation of a large-sigma Gaussian (NHWC)."""
    for r in _boxes_for_gauss(sigma):
        x = _box_blur_axis(x, r, axis=1)
        x = _box_blur_axis(x, r, axis=2)
    return x


def single_scale_retinex(x: torch.Tensor, sigma: float, eps: float = _EPS) -> torch.Tensor:
    """SSR: log(x) - log(G_sigma * x), per channel. x: NHWC float [0,1]."""
    return torch.log(x + eps) - torch.log(gaussian_blur_approx(x, sigma) + eps)


def multi_scale_retinex(
    x: torch.Tensor,
    sigmas: tuple[float, ...] = (15.0, 80.0, 250.0),
    weights: tuple[float, ...] | None = None,
    eps: float = _EPS,
) -> torch.Tensor:
    """MSR: weighted sum of SSR responses. One log(x) is shared across scales."""
    if weights is None:
        weights = tuple(1.0 / len(sigmas) for _ in sigmas)
    log_x = torch.log(x + eps)
    out = torch.zeros_like(x)
    for s, w in zip(sigmas, weights):
        out = out + w * (log_x - torch.log(gaussian_blur_approx(x, s) + eps))
    return out


def color_restoration(x: torch.Tensor, alpha: float = 125.0, beta: float = 46.0, eps: float = _EPS) -> torch.Tensor:
    """MSRCR color-restoration factor C = beta*(log(alpha*I_c) - log(sum_c I_c))."""
    s = torch.sum(x, dim=-1, keepdim=True)
    return beta * (torch.log(alpha * x + eps) - torch.log(s + eps))


def _quantiles_from_histogram(x: torch.Tensor, lo_frac: float, hi_frac: float, bins: int = 512):
    """Per-image (lo, hi) quantiles of a [B, ...] tensor via a histogram CDF.
    Returns ([B], [B]) in the data's value range."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    mn = torch.amin(flat, dim=1, keepdim=True)
    mx = torch.amax(flat, dim=1, keepdim=True)
    scale = (mx - mn) + 1e-12
    idx = torch.clamp(((flat - mn) / scale * bins).to(torch.int32), 0, bins - 1).long()
    hist = torch.zeros((b, bins), dtype=torch.float32, device=x.device)
    hist.scatter_add_(1, idx, torch.ones_like(flat, dtype=torch.float32))
    cdf = torch.cumsum(hist, dim=1) / flat.shape[1]
    edges = torch.arange(bins, dtype=torch.float32, device=x.device) / bins  # bin left edges in [0,1)

    def q(frac):
        # First bin whose CDF reaches frac.
        pos = torch.argmax((cdf >= frac).to(torch.int32), dim=1)
        return mn[:, 0] + (edges[pos] + 0.5 / bins) * scale[:, 0]

    return q(lo_frac), q(hi_frac)


def percentile_stretch(x: torch.Tensor, clip: float = 0.01) -> torch.Tensor:
    """Per-image linear stretch clipping `clip` mass at each tail; maps
    [q_lo, q_hi] -> [0, 1]."""
    lo, hi = _quantiles_from_histogram(x, clip, 1.0 - clip)
    lo = lo.reshape(-1, *([1] * (x.ndim - 1)))
    hi = hi.reshape(-1, *([1] * (x.ndim - 1)))
    return torch.clamp((x - lo) / (hi - lo + 1e-8), 0.0, 1.0)


def msr_enhance(
    x: torch.Tensor,
    sigmas: tuple[float, ...] = (15.0, 80.0, 250.0),
    mode: str = "msr",
    clip: float = 0.01,
) -> torch.Tensor:
    """MSR (optionally with MSRCR color restoration) + percentile stretch
    back to [0,1]. x: NHWC (or HWC) float [0,1]."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    r = multi_scale_retinex(x, sigmas)
    if mode == "msrcr":
        r = r * color_restoration(x)
    out = percentile_stretch(r, clip)
    return out[0] if squeeze else out


def ssr_enhance(x: torch.Tensor, sigma: float = 80.0, clip: float = 0.01) -> torch.Tensor:
    """Single-scale Retinex enhance + percentile stretch."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = percentile_stretch(single_scale_retinex(x, sigma), clip)
    return out[0] if squeeze else out

