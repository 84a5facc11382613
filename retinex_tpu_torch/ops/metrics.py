"""Image-quality metrics on a batch, in PyTorch (NHWC float [0,1]).

Counterpart of ``retinex_tpu/ops/metrics.py``: brightness, contrast,
entropy, PSNR, MSE, per-channel 11x11-box SSIM, simplified NIQE, saturation
and naturalness. The JAX functions take one image (``evaluate`` vmaps them);
these take a batch [B,H,W,C] and return one value per image, [B].

Standard deviations are population ones (``correction=0``), as ``jnp.std``.
"""

from __future__ import annotations

import torch

from retinex_tpu_torch.ops.colorspace import saturation_map
from retinex_tpu_torch.ops.filters import box_filter, uniform_filter

_HWC = (1, 2, 3)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return torch.mean((img1 - img2) ** 2, dim=_HWC)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR in dB, max_pixel=1.0; 100 where the images are (near) equal."""
    m = mse(img1, img2)
    return torch.where(m < 1e-10, 100.0, 20.0 * torch.log10(1.0 / torch.sqrt(m)))


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-channel SSIM with an 11x11 normalized box window and zero-padded
    borders, averaged over pixels and channels."""
    c1 = 0.01**2
    c2 = 0.03**2
    mu1 = box_filter(img1, 11)
    mu2 = box_filter(img2, 11)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = box_filter(img1 * img1, 11) - mu1_sq
    sigma2_sq = box_filter(img2 * img2, 11) - mu2_sq
    sigma12 = box_filter(img1 * img2, 11) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map, dim=_HWC)


def entropy(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Shannon entropy of each image's intensity histogram over [0,1], with
    np.histogram's bins (right-inclusive last bin)."""
    flat = img.reshape(img.shape[0], -1).contiguous()
    # jnp.linspace(0, 1, bins + 1) in f32: i / bins, exact for bins = 256.
    edges = torch.arange(bins + 1, dtype=torch.float32, device=img.device) / bins
    idx = torch.clamp(torch.searchsorted(edges, flat, right=True) - 1, 0, bins - 1)
    hist = torch.zeros((img.shape[0], bins), dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(flat))
    p = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
    plogp = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)), 0.0)
    return -plogp.sum(dim=1)


def niqe_simplified(img: torch.Tensor) -> torch.Tensor:
    """Local 7x7 mean/sigma on Rec.601 gray; score = mean(sigma) / (std(mu)
    + 1e-8)."""
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    g = gray[..., None]
    mu = uniform_filter(g, 7)
    var = uniform_filter(g * g, 7) - mu * mu
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.mean(sigma, dim=_HWC) / (torch.std(mu, dim=_HWC, correction=0) + 1e-8)


def saturation(img: torch.Tensor) -> torch.Tensor:
    """Mean HSV-style saturation."""
    return torch.mean(saturation_map(img), dim=(1, 2))


def naturalness(img: torch.Tensor) -> torch.Tensor:
    """0.3 * colour balance + 0.4 * contrast score + 0.3 * brightness score."""
    chan_means = torch.mean(img[..., :3], dim=(1, 2))  # [B, 3]
    color_balance = 1.0 - torch.std(chan_means, dim=1, correction=0)
    contrast = torch.std(img, dim=_HWC, correction=0)
    contrast_score = torch.clamp(1.0 - torch.abs(contrast - 0.15) / 0.15, 0.0, 1.0)
    brightness = torch.mean(img, dim=_HWC)
    brightness_score = torch.clamp(1.0 - torch.abs(brightness - 0.5) / 0.5, 0.0, 1.0)
    return 0.3 * color_balance + 0.4 * contrast_score + 0.3 * brightness_score


def calculate_metrics(img_enhanced: torch.Tensor, img_reference: torch.Tensor | None = None) -> dict:
    """The metric bundle, one [B] tensor per key, in the JAX package's key
    order; psnr, ssim and mse only with a reference batch."""
    m = {
        "mean_brightness": torch.mean(img_enhanced, dim=_HWC),
        "contrast": torch.std(img_enhanced, dim=_HWC, correction=0),
        "entropy": entropy(img_enhanced),
        "niqe": niqe_simplified(img_enhanced),
        "saturation": saturation(img_enhanced),
        "naturalness": naturalness(img_enhanced),
    }
    if img_reference is not None:
        m["psnr"] = psnr(img_enhanced, img_reference)
        m["ssim"] = ssim(img_enhanced, img_reference)
        m["mse"] = mse(img_enhanced, img_reference)
    return m
