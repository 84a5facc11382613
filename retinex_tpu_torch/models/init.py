"""Flax's default initialisation, drawn from a seeded torch generator.

The JAX package initialises every network with ``model.init``: Flax's
lecun_normal kernels and zero biases, BatchNorm at identity. The untrained
net of the CLI (seed 0, as the JAX CLI's ``PRNGKey(0)``) and the VGG19 of
the perceptual loss (seed 42, as the JAX trainer's ``PRNGKey(42)``) both
come from ``init_untrained``.
"""

from __future__ import annotations

import math

import torch

# Flax's lecun_normal: a normal truncated at +-2 standard deviations, scaled
# so the samples' std is sqrt(1/fan_in); 0.879... is the std of a standard
# normal truncated at +-2 (jax.nn.initializers.variance_scaling).
TRUNC_STD = 0.87962566103423978


def fan_in(m: torch.nn.Module) -> int:
    """Flax's fan-in of a convolution's kernel: kh * kw * input channels.
    Conv2d keeps them as [out, in/groups, kh, kw], ConvTranspose2d as
    [in, out/groups, kh, kw]; Flax counts the input axis of the HWIO kernel
    for both (``in_axis=-2``)."""
    w = m.weight
    cin = w.shape[0] if isinstance(m, torch.nn.ConvTranspose2d) else w.shape[1]
    return cin * w.shape[2] * w.shape[3]


def _truncated_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """t <- std * N(0, 1) truncated to [-2, 2], by redrawing what falls outside."""
    z = torch.randn(t.shape, generator=g)
    bad = z.abs() > 2
    while bool(bad.any()):
        z[bad] = torch.randn(int(bad.sum()), generator=g)
        bad = z.abs() > 2
    t.copy_(z * std)


def init_untrained(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Untrained weights as the JAX package's ``model.init`` draws them:
    every convolution kernel from Flax's lecun_normal (std sqrt(1/fan_in),
    truncated at +-2 sigma, sigma = sqrt(1/fan_in) / TRUNC_STD), every bias
    0, BatchNorm at identity. The draws come from a seeded generator on the
    CPU, so every device gets the same numbers; they are not JAX's (threefry
    and Flax's per-module keys), only their distribution is."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                _truncated_normal_(m.weight, math.sqrt(1.0 / fan_in(m)) / TRUNC_STD, g)
                if m.bias is not None:
                    m.bias.zero_()
    return model
