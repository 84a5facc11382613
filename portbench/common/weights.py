"""Seeded weights, made on the device in a few large calls.

Convolution kernels follow Flax's lecun-normal as the port's
``models/init.py`` draws it (a standard normal truncated at +-2, scaled to
std sqrt(1 / fan_in) / 0.8796...), but all kernels come from one draw on
the device. Biases, and the BatchNorm affines and running statistics, are
drawn small and away from their identity values, so that the packed
path's folding of biases and BatchNorms into the kernels is exercised.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

TRUNC_STD = 0.87962566103423978

# VGG19's features to pool3 (torchvision indices): output channels.
VGG_CONVS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256}


def _fan_in(shape, kind) -> int:
    cin = shape[0] if kind == "convT" else shape[1]
    return cin * shape[2] * shape[3]


def _truncated_normal(n: int, g: torch.Generator, device) -> torch.Tensor:
    z = torch.randn(n, generator=g, device=device)
    while True:
        bad = z.abs() > 2
        k = int(bad.sum())
        if k == 0:
            return z
        z[bad] = torch.randn(k, generator=g, device=device)


def draw(spec: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict for `spec` (name -> (shape, kind), ``reference.net.spec``)
    drawn from `seed` on `device`, f32."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [(k, s, kind) for k, (s, kind) in spec.items() if kind in ("conv", "convT")]
    vectors = [(k, s, kind) for k, (s, kind) in spec.items() if kind in ("bias", "bn_w", "bn_b", "bn_mean", "bn_var")]
    z = _truncated_normal(sum(math.prod(s) for _, s, _ in kernels), g, device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in vectors), generator=g, device=device)
    n = torch.randn(u.numel(), generator=g, device=device)
    sd: dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in kernels:
        size = math.prod(shape)
        std = math.sqrt(1.0 / _fan_in(shape, kind)) / TRUNC_STD
        sd[name] = (z[off : off + size] * std).reshape(shape)
        off += size
    off = 0
    for name, shape, kind in vectors:
        size = math.prod(shape)
        uu, nn_ = u[off : off + size].reshape(shape), n[off : off + size].reshape(shape)
        off += size
        if kind == "bias":
            sd[name] = 0.02 * nn_
        elif kind == "bn_w":
            sd[name] = 0.8 + 0.4 * uu
        elif kind == "bn_b":
            sd[name] = 0.05 * nn_
        elif kind == "bn_mean":
            sd[name] = 0.05 * nn_
        else:
            sd[name] = 0.6 + 0.8 * uu
    for name, (shape, kind) in spec.items():
        if kind == "count":
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
    return {k: sd[k].contiguous() for k in spec}


def write_pth(sd: dict[str, torch.Tensor], path: str) -> str:
    """The state dict as a reference-format checkpoint ({'epoch',
    'model_state_dict'}), the file ``--checkpoint`` takes."""
    torch.save({"epoch": 0, "model_state_dict": {k: v.detach().cpu() for k, v in sd.items()}}, path)
    return path


def vgg_spec() -> dict:
    spec, cin = {}, 3
    for i, cout in VGG_CONVS.items():
        spec[f"{i}.weight"] = ((cout, cin, 3, 3), "conv")
        spec[f"{i}.bias"] = ((cout,), "bias")
        cin = cout
    return spec


def write_vgg_npz(sd: dict[str, torch.Tensor], path: str) -> str:
    """VGG19 feature weights as the .npz of torchvision keys that
    ``--vgg_weights`` takes."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in sd.items()})
    return path


def scratch_dir(prefix: str) -> str:
    """A fresh directory under TMPDIR for this run's inputs."""
    import tempfile

    return tempfile.mkdtemp(prefix=prefix, dir=os.environ.get("TMPDIR") or None)
