"""Small spatial filters as shifted-slice correlations (NHWC), in PyTorch.

Counterpart of ``retinex_tpu/ops/filters.py``: Gaussian blur, Laplacian,
Sobel, box / uniform filters and finite differences, with OpenCV's
BORDER_REFLECT_101 padding unless noted. ``_depthwise_conv`` keeps the JAX
package's tap-weighted shifted-slice form, its taps summed in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _depthwise_conv(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Depthwise 2-D correlation, NHWC, VALID padding, as a sum of shifted
    slices weighted by the taps (zero taps skipped), in row-major tap order.
    kernel: [kh, kw]."""
    kh, kw = kernel.shape
    h, w = x.shape[1], x.shape[2]
    taps = np.asarray(kernel, dtype=np.float32)
    out = None
    for i in range(kh):
        for j in range(kw):
            t = float(taps[i, j])
            if t == 0.0:
                continue
            piece = x[:, i : i + h - kh + 1, j : j + w - kw + 1, :] * t
            out = piece if out is None else out + piece
    return out


def _pad_hw(x: torch.Tensor, ph: tuple[int, int], pw: tuple[int, int], mode: str) -> torch.Tensor:
    """Pad the H and W axes of an NHWC tensor (through an NCHW view)."""
    xc = x.permute(0, 3, 1, 2)
    if mode == "symmetric":  # edge-inclusive reflect (d c b a | a b c d)
        idx_h = _symmetric_index(x.shape[1], *ph, x.device)
        idx_w = _symmetric_index(x.shape[2], *pw, x.device)
        out = xc.index_select(2, idx_h).index_select(3, idx_w)
    else:
        out = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), mode=mode)
    return out.permute(0, 2, 3, 1)


def _symmetric_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    idx = np.arange(-lo, n + hi)
    period = 2 * n
    idx = np.mod(idx, period)
    idx = np.where(idx >= n, period - 1 - idx, idx)
    return torch.as_tensor(idx, device=device)


def _reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of H and W (numpy's mode='reflect')."""
    return _pad_hw(x, (ph, ph), (pw, pw), "reflect")


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics: sigma<=0 derives sigma from ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    xs = [i - half for i in range(ksize)]
    vals = [math.exp(-(v * v) / (2.0 * sigma * sigma)) for v in xs]
    s = sum(vals)
    return np.asarray([v / s for v in vals], dtype=np.float32)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur, NHWC, reflect-101 border."""
    k1 = gaussian_kernel_1d(ksize, sigma)
    p = ksize // 2
    x = _depthwise_conv(_reflect_pad(x, p, 0), k1.reshape(ksize, 1))
    return _depthwise_conv(_reflect_pad(x, 0, p), k1.reshape(1, ksize))


_LAPLACIAN_K1 = np.asarray([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], dtype=np.float32)
_SOBEL_X = np.asarray([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], dtype=np.float32)
_SOBEL_Y = np.asarray([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], dtype=np.float32)


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian (cv2.Laplacian ksize=1 kernel), reflect-101 border."""
    return _depthwise_conv(_reflect_pad(x, 1, 1), _LAPLACIAN_K1)


def sobel_xy(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients (gx, gy), reflect-101 border."""
    xp = _reflect_pad(x, 1, 1)
    return _depthwise_conv(xp, _SOBEL_X), _depthwise_conv(xp, _SOBEL_Y)


def sobel_edge_map(x: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude sqrt(gx^2+gy^2) on the channel-mean gray image."""
    gx, gy = sobel_xy(torch.mean(x, dim=-1, keepdim=True))
    return torch.sqrt(gx * gx + gy * gy)


def box_filter(x: torch.Tensor, ksize: int, normalize: bool = True) -> torch.Tensor:
    """Separable box filter with zero padding (scipy 'constant' mode)."""
    k1 = np.full((ksize,), 1.0 / ksize if normalize else 1.0, dtype=np.float32)
    p = ksize // 2
    x = _depthwise_conv(_pad_hw(x, (p, p), (0, 0), "constant"), k1.reshape(ksize, 1))
    return _depthwise_conv(_pad_hw(x, (0, 0), (p, p), "constant"), k1.reshape(1, ksize))


def uniform_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """scipy.ndimage.uniform_filter (mode='reflect', which repeats the edge
    sample: numpy's mode='symmetric', unlike OpenCV's reflect-101)."""
    k1 = np.full((ksize,), 1.0 / ksize, dtype=np.float32)
    p_lo = ksize // 2
    p_hi = ksize - 1 - p_lo
    x = _depthwise_conv(_pad_hw(x, (p_lo, p_hi), (0, 0), "symmetric"), k1.reshape(ksize, 1))
    return _depthwise_conv(_pad_hw(x, (0, 0), (p_lo, p_hi), "symmetric"), k1.reshape(1, ksize))


def forward_diff(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences (grad_h along W, grad_v along H), sign convention
    x[i] - x[i+1]. NHWC."""
    return x[:, :, :-1, :] - x[:, :, 1:, :], x[:, :-1, :, :] - x[:, 1:, :, :]


def central_gradient(x: torch.Tensor, axis: int) -> torch.Tensor:
    """torch.gradient's semantics: central differences in the interior,
    one-sided at the boundaries. axis is the spatial axis of the NHWC tensor
    (1=H, 2=W)."""
    n = x.shape[axis]
    interior = (x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) * 0.5
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)
