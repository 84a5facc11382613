"""The seven unsupervised losses (NHWC, float [0,1]), in PyTorch.

Counterpart of ``retinex_tpu/losses/losses.py``, with the reference quirks
it keeps (each noted in place). Every loss returns a 0-dim tensor and is
differentiable in its first argument. Where JAX's gradient convention at a
tie differs from PyTorch's (``jnp.maximum`` and ``jnp.clip`` split it in
half, ``torch.clamp`` passes it whole), the ops are written as the JAX
package's; none of these losses meets such a tie on a differentiated path
(``jnp.abs`` and ``torch.abs`` both give 0 at 0).

Under ``--use_amp`` the net's three outputs are f32 (``models/retinex_net.py``)
and only VGG19's features are bf16: the perceptual MSE squares their
difference in bf16 and takes its mean as ``jnp.mean`` does (an f32 sum,
one rounding), and the total stacks it with the f32
losses, promoted to f32 as ``jnp.stack`` promotes it. ``jnp.fft.fft2``
promotes bf16 to complex64; the frequency loss widens a bf16 input to f32
explicitly (PyTorch's CPU FFT takes no bf16).

Across ranks (``parallel/distributed.py``) each rank holds rows of the
global batch. A mean over samples is then this rank's share of it
(``share_mean``: its sum over the global count), so the ranks' losses add
up to the global batch's; the batch-global statistics (the exposure
target's mean, the colour loss's channel means) are the global batch's
(``global_mean``), whole on every rank, and the colour loss, which every
rank computes whole, counts in the loss the ranks' sums report once
(``losses/total.py``). In a world of one rank each is the plain mean.
"""

from __future__ import annotations

import torch

from retinex_tpu_torch.ops.filters import forward_diff, sobel_edge_map
from retinex_tpu_torch.parallel.distributed import global_mean, share_mean


def _gray(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=-1, keepdim=True)


def exposure_loss(
    img_enhanced: torch.Tensor, img_low: torch.Tensor, patch_size: int = 16, base_target: float = 0.6
) -> torch.Tensor:
    """Gray patch means of the enhanced image against the adaptive target
    base + (0.8 - base) * (1 - mean(gray_low)); L1 over patches. Remainder
    rows and columns are ignored (avg_pool2d floors)."""
    gray_enh = _gray(img_enhanced)
    target = base_target + (0.8 - base_target) * (1.0 - global_mean(_gray(img_low)))
    b, h, w, _ = gray_enh.shape
    ph, pw = h // patch_size, w // patch_size
    cropped = gray_enh[:, : ph * patch_size, : pw * patch_size, 0]
    patches = cropped.reshape(b, ph, patch_size, pw, patch_size).mean(dim=(2, 4))
    return share_mean((patches - target).abs())


def smoothness_loss(
    illu_map: torch.Tensor, img_low: torch.Tensor, lambda_val: float = 10.0, alpha: float = 1.0
) -> torch.Tensor:
    """Edge-aware TV of the illumination map, weighted by
    exp(-lambda * mean_c |grad S|) and by per-row / per-column edge factors
    1 + alpha * mean(edge_map[..., :-1]) along that row / column (the
    reference's avg_pool2d over a whole row or column, kept)."""
    illu_gh, illu_gv = forward_diff(illu_map)
    img_gh, img_gv = forward_diff(img_low)
    weight_h = torch.exp(-lambda_val * img_gh.abs().mean(dim=-1, keepdim=True))
    weight_v = torch.exp(-lambda_val * img_gv.abs().mean(dim=-1, keepdim=True))
    edge = sobel_edge_map(img_low)  # [B,H,W,1]
    edge_factor_h = 1.0 + alpha * edge[:, :, :-1, :].mean(dim=2, keepdim=True)
    edge_factor_v = 1.0 + alpha * edge[:, :-1, :, :].mean(dim=1, keepdim=True)
    loss_h = share_mean(weight_h * edge_factor_h * illu_gh.abs())
    loss_v = share_mean(weight_v * edge_factor_v * illu_gv.abs())
    return loss_h + loss_v


def color_loss(img_enhanced: torch.Tensor) -> torch.Tensor:
    """Gray-world colour constancy: squared pairwise differences of the
    global per-channel means (the global batch's, whole on every rank)."""
    means = global_mean(img_enhanced, dim=(0, 1, 2))
    mr, mg, mb = means[0], means[1], means[2]
    return torch.square(mr - mg) + torch.square(mr - mb) + torch.square(mg - mb)


def spatial_consistency_loss(img_enhanced: torch.Tensor, img_low: torch.Tensor) -> torch.Tensor:
    """MSE between the forward-difference gradients of enhanced and input."""
    egh, egv = forward_diff(img_enhanced)
    lgh, lgv = forward_diff(img_low)
    return share_mean(torch.square(egh - lgh)) + share_mean(torch.square(egv - lgv))


def decoupling_loss(illu_map: torch.Tensor, reflectance: torch.Tensor, lambda_val: float = 0.1) -> torch.Tensor:
    """||cross-cov||_F^2 + lambda * MSE of the channel-averaged means. For
    1-channel illumination against 3-channel reflectance the reference
    correlates the uncentered, replicated illumination with the centered
    reflectance (kept)."""
    b, h, w, c_illu = illu_map.shape
    c_refl = reflectance.shape[-1]
    n = h * w
    illu_flat = illu_map.reshape(b, n, c_illu)
    refl_flat = reflectance.reshape(b, n, c_refl)
    illu_mean = illu_flat.mean(dim=1, keepdim=True)
    refl_mean = refl_flat.mean(dim=1, keepdim=True)
    refl_centered = refl_flat - refl_mean
    if c_illu == c_refl:
        cov = torch.einsum("bnc,bnd->bcd", illu_flat - illu_mean, refl_centered) / (n - 1)
        mean_diff = share_mean(torch.square(illu_mean - refl_mean))
    else:
        illu_rep = illu_flat.expand(b, n, c_refl)
        cov = torch.einsum("bnc,bnd->bcd", illu_rep, refl_centered) / (n - 1)
        mean_diff = share_mean(torch.square(illu_mean.mean(dim=2) - refl_mean.mean(dim=2)))
    return torch.square(cov).sum() + lambda_val * mean_diff


def perceptual_loss(vgg, img_enhanced: torch.Tensor, img_low: torch.Tensor) -> torch.Tensor:
    """VGG feature-space MSE between enhanced and the *input* at three
    depths; `vgg(x) -> (f1, f2, f3)` (models/vgg.py), in the features'
    dtype."""
    fe = vgg(img_enhanced)
    fl = vgg(img_low)
    return sum(share_mean(torch.square(a - b).float()).to(a.dtype) for a, b in zip(fe, fl))


def frequency_masks(h: int, w: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """High / low masks on the *unshifted* spectrum: a disk of radius
    min(H,W)//4 around (H//2, W//2). DC lives at [0,0], so the 'low' disk
    covers the Nyquist band (reference quirk, kept)."""
    yy = (torch.arange(h, device=device)[:, None] - h // 2).float()
    xx = (torch.arange(w, device=device)[None, :] - w // 2).float()
    dist = torch.sqrt(torch.square(xx) + torch.square(yy))
    low = (dist <= min(h, w) // 4).float()
    return 1.0 - low, low


def frequency_loss(
    img_enhanced: torch.Tensor, img_low: torch.Tensor, weight_high: float = 1.0, weight_low: float = 0.5
) -> torch.Tensor:
    """FFT magnitude-spectrum MSE split by the radial mask (FFT over the
    spatial axes of NHWC)."""
    h, w = img_enhanced.shape[1], img_enhanced.shape[2]
    mag_e = torch.fft.fft2(img_enhanced.float(), dim=(1, 2)).abs()
    mag_l = torch.fft.fft2(img_low.float(), dim=(1, 2)).abs()
    high, low = (m[None, :, :, None] for m in frequency_masks(h, w, img_enhanced.device))
    high_loss = share_mean(torch.square(mag_e * high - mag_l * high))
    low_loss = share_mean(torch.square(mag_e * low - mag_l * low))
    return weight_high * high_loss + weight_low * low_loss


def texture_complexity(img: torch.Tensor, method: str = "tv") -> torch.Tensor:
    """Per-sample texture complexity, [B]. 'tv': mean |forward diff| (h + v);
    'edge_density': fraction of Sobel magnitudes above 1.5x their mean."""
    if method == "tv":
        gh, gv = forward_diff(img)
        return gh.abs().mean(dim=(1, 2, 3)) + gv.abs().mean(dim=(1, 2, 3))
    if method == "edge_density":
        edge = sobel_edge_map(img)
        thresh = edge.mean(dim=(1, 2, 3), keepdim=True) * 1.5
        return (edge > thresh).float().mean(dim=(1, 2, 3))
    raise ValueError(f"unknown texture method: {method}")
