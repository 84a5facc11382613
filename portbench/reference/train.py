"""Plain reference of the training step, frozen for the benchmark.

The JAX package's step at its defaults, written out in plain PyTorch over
the reference net (``reference/net.py``) in train mode:

- the seven unsupervised losses of the reference repository (exposure,
  edge-aware smoothness, colour constancy, spatial consistency,
  decoupling, the VGG19 perceptual loss to pool3; the frequency loss off)
  with the static weights and the texture-adaptive smoothness weight;
- the gradients by autograd;
- optax's chain: clip by global norm 1.0 (kept where the norm is under
  it, else scaled to it), weight decay 1e-5 added to every gradient, Adam
  (0.9, 0.999, 1e-8) with bias correction, the learning rate 1e-4 of the
  first epoch;
- BatchNorm's running statistics as Flax updates them.

The batches are the benchmark's own u8 photos in the loader's order,
flipped and rotated by the draws of a generator seeded as the trainer
seeds its augmentation.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.net import Net

WEIGHTS = {"exposure": 10.0, "smoothness": 1.0, "color": 0.5, "spatial": 1.0, "decouple": 0.1, "perceptual": 1.0}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_LAYERS = (0, 2, "pool", 5, 7, "pool", 10, 12, 14, 16, "pool")
RECIP_255 = float(np.float32(1.0) / np.float32(255.0))


def vgg_features(sd, x_nhwc, conv):
    mean = torch.tensor(IMAGENET_MEAN, device=x_nhwc.device, dtype=x_nhwc.dtype)
    std = torch.tensor(IMAGENET_STD, device=x_nhwc.device, dtype=x_nhwc.dtype)
    y = ((x_nhwc - mean) / std).permute(0, 3, 1, 2)
    feats = []
    for layer in VGG_LAYERS:
        if layer == "pool":
            y = F.max_pool2d(y, 2, 2)
            feats.append(y)
        else:
            y = F.relu(conv(y, sd[f"{layer}.weight"], sd[f"{layer}.bias"], 1, 1, 1))
    return feats


def _diffs(x):
    return x[:, :, :-1, :] - x[:, :, 1:, :], x[:, :-1, :, :] - x[:, 1:, :, :]


def _sobel_edge(x):
    gray = x.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2)
    p = F.pad(gray, (1, 1, 1, 1), mode="reflect")
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=x.device, dtype=x.dtype)
    gx = F.conv2d(p, kx[None, None])
    gy = F.conv2d(p, kx.t()[None, None])
    return torch.sqrt(gx * gx + gy * gy).permute(0, 2, 3, 1)


def losses(low, enhanced, illu, refl, vgg_sd, conv):
    """The six active losses (NHWC inputs), by name."""
    gray_e = enhanced.mean(dim=-1)
    target = 0.6 + 0.2 * (1.0 - low.mean())
    b, h, w = gray_e.shape
    ph, pw = h // 16, w // 16
    patches = gray_e[:, : ph * 16, : pw * 16].reshape(b, ph, 16, pw, 16).mean(dim=(2, 4))
    exposure = (patches - target).abs().mean()

    igh, igv = _diffs(illu)
    lgh, lgv = _diffs(low)
    edge = _sobel_edge(low)
    wh = torch.exp(-10.0 * lgh.abs().mean(dim=-1, keepdim=True)) * (1.0 + edge[:, :, :-1, :].mean(dim=2, keepdim=True))
    wv = torch.exp(-10.0 * lgv.abs().mean(dim=-1, keepdim=True)) * (1.0 + edge[:, :-1, :, :].mean(dim=1, keepdim=True))
    smoothness = (wh * igh.abs()).mean() + (wv * igv.abs()).mean()

    m = enhanced.mean(dim=(0, 1, 2))
    color = (m[0] - m[1]) ** 2 + (m[0] - m[2]) ** 2 + (m[1] - m[2]) ** 2

    egh, egv = _diffs(enhanced)
    spatial = ((egh - lgh) ** 2).mean() + ((egv - lgv) ** 2).mean()

    n = h * w
    i_flat = illu.reshape(b, n, 1)
    r_flat = refl.reshape(b, n, 3)
    i_mean, r_mean = i_flat.mean(dim=1, keepdim=True), r_flat.mean(dim=1, keepdim=True)
    cov = torch.einsum("bnc,bnd->bcd", i_flat.expand(b, n, 3), r_flat - r_mean) / (n - 1)
    decouple = (cov**2).sum() + 0.1 * ((i_mean.mean(dim=2) - r_mean.mean(dim=2)) ** 2).mean()

    fe, fl = vgg_features(vgg_sd, enhanced, conv), vgg_features(vgg_sd, low, conv)
    perceptual = sum(((a.permute(0, 2, 3, 1) - c.permute(0, 2, 3, 1)) ** 2).mean() for a, c in zip(fe, fl))
    return {"exposure": exposure, "smoothness": smoothness, "color": color, "spatial": spatial,
            "decouple": decouple, "perceptual": perceptual}


def smooth_weight(low):
    gh, gv = _diffs(low)
    tv = gh.abs().mean(dim=(1, 2, 3)) + gv.abs().mean(dim=(1, 2, 3))
    return torch.clamp(1.0 - tv.mean() * 0.8, 0.1, 5.0)


def draws(gen, b, device):
    """One batch's augmentation draws from `gen`, in the trainer's order:
    (horizontal flips, vertical flips, turns, quarter turns)."""
    hflip = torch.rand((b, 1, 1, 1), generator=gen, device=device).view(b) < 0.5
    vflip = torch.rand((b, 1, 1, 1), generator=gen, device=device).view(b) < 0.5
    rot = torch.rand((b, 1, 1, 1), generator=gen, device=device).view(b) < 0.5
    return hflip, vflip, rot, torch.randint(1, 4, (b,), generator=gen, device=device)


def augment(batch_u8, gen):
    """The trainer's basic augmentation of a u8 NHWC batch with draws from
    `gen`: per sample a horizontal flip, a vertical flip (each p 0.5) and,
    on a square canvas, 1-3 quarter turns with p 0.5."""
    b = batch_u8.shape[0]
    hflip, vflip, rot, k = draws(gen, b, batch_u8.device)
    x = batch_u8.float() * RECIP_255
    out = []
    for i in range(b):
        xi = x[i]
        if hflip[i]:
            xi = torch.flip(xi, dims=(1,))
        if vflip[i]:
            xi = torch.flip(xi, dims=(0,))
        if rot[i] and xi.shape[0] == xi.shape[1]:
            xi = torch.rot90(xi, int(k[i]), dims=(0, 1))
        out.append(xi)
    return torch.stack(out)


class Step:
    """The reference train state: parameters, running statistics, Adam.
    It starts from Adam's zero state, or from `adam` (its first and second
    moments by leaf and its count)."""

    def __init__(self, sd, trainable, vgg_sd, use_preact, use_aspp, conv=None, conv_t=None, lr=1e-4, wd=1e-5,
                 adam=None):
        self.sd = {k: v.clone() for k, v in sd.items()}
        self.names = list(trainable)
        self.vgg_sd = vgg_sd
        self.use_preact, self.use_aspp = use_preact, use_aspp
        self.conv = conv or F.conv2d
        self.conv_t = conv_t
        self.lr, self.wd = lr, wd
        if adam is None:
            self.mu = {k: torch.zeros_like(self.sd[k]) for k in self.names}
            self.nu = {k: torch.zeros_like(self.sd[k]) for k in self.names}
            self.count = 0
        else:
            mu, nu, self.count = adam
            self.mu = {k: mu[k].clone() for k in self.names}
            self.nu = {k: nu[k].clone() for k in self.names}

    def loss_and_grads(self, batch):
        params = {k: self.sd[k].detach().requires_grad_(True) for k in self.names}
        sd = {**self.sd, **params}
        net = Net(sd, self.use_preact, self.use_aspp, train=True, conv=self.conv, conv_t=self.conv_t)
        enh, refl, illu = (t.permute(0, 2, 3, 1) for t in net(batch.permute(0, 3, 1, 2)))
        self.illu = illu.detach()
        parts = losses(batch, enh, illu, refl, self.vgg_sd, self.conv)
        weights = dict(WEIGHTS, smoothness=float(smooth_weight(batch)))
        total = sum(weights[k] * v for k, v in parts.items())
        grads = torch.autograd.grad(total, [params[k] for k in self.names])
        return float(total.detach()), dict(zip(self.names, grads)), net.stats

    def step(self, batch):
        """One step; returns (total loss, the gradients Adam took)."""
        total, grads, stats = self.loss_and_grads(batch)
        with torch.no_grad():
            return total, self._apply(grads, stats)

    def _apply(self, grads, stats):
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        self.count += 1
        bc1, bc2 = 1 - 0.9**self.count, 1 - 0.999**self.count
        taken = {}
        for k in self.names:
            g = grads[k] if norm < 1.0 else grads[k] / norm
            g = g + self.wd * self.sd[k]
            taken[k] = g
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
            self.sd[k] = self.sd[k] - self.lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8)
        self.sd.update(stats)
        return taken
