"""VGG19 feature slices for the perceptual loss, in PyTorch.

Counterpart of ``retinex_tpu/models/vgg.py``: torchvision's ``vgg19.features``
up to index 18, whose outputs at indices 4, 9 and 18 (pool1, pool2 and
pool3: 64 channels at /2, 128 at /4, 256 at /8) are the three features. The
module is an ``nn.Sequential`` of those 19 layers, so its state_dict keys are
torchvision's (``0.weight``, ``2.weight``, ... ``16.bias``). Input NHWC RGB
in [0, 1], normalised by the ImageNet mean and std (rounded to the input's
dtype).

``dtype`` is the compute dtype of the JAX module's: in bf16 (``--use_amp``
training) each convolution computes as Flax's ``nn.Conv(dtype=bf16)``
(``models/layers.Conv``: the input and the kernel rounded to bf16, the f32
sum rounded, then the bias added in bf16) with the parameters kept f32, and
the three features come out bf16.

Weights: none are downloaded. ``default_vgg`` draws them as the JAX trainer
does (``VGG19Features().init(PRNGKey(42))``: Flax's lecun_normal, zero
biases) from seed 42 with ``models/init.init_untrained``; ``load_npz`` and
``load_torch_state_dict`` read a user's exported torchvision weights. The
parameters are frozen; gradients flow to the input.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.layers import Conv

# The convolutions by torchvision index, with their output channels.
CONVS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256}
POOLS = (4, 9, 18)  # each ends a slice; its output is a feature
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# The JAX trainer initialises the perceptual loss's VGG from PRNGKey(42).
VGG_SEED = 42


class VGG19Features(nn.Sequential):
    """Three-stage VGG19 feature extractor (pool1/pool2/pool3 outputs)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        layers, cin = [], 3
        for i in range(POOLS[-1] + 1):
            if i in CONVS:
                layers.append(Conv(cin, CONVS[i], 3, padding=1, dtype=dtype))
                cin = CONVS[i]
            elif i in POOLS:
                layers.append(nn.MaxPool2d(2, 2))  # post-ReLU input: max_pool_nonneg
            else:
                layers.append(nn.ReLU())
        super().__init__(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x: [B,H,W,3] in [0,1] -> (f1, f2, f3), NHWC views."""
        y = ((x - self.mean.to(x.dtype)) / self.std.to(x.dtype)).permute(0, 3, 1, 2)
        outs = []
        for i, layer in enumerate(self):
            y = layer(y)
            if i in POOLS:
                outs.append(y.permute(0, 2, 3, 1))
        return tuple(outs)


def default_vgg(dtype: torch.dtype = torch.float32) -> VGG19Features:
    """The JAX trainer's default VGG: lecun-normal weights from seed 42,
    computing in `dtype`."""
    return init_untrained(VGG19Features(dtype), VGG_SEED)


def load_torch_state_dict(state_dict, dtype: torch.dtype = torch.float32) -> VGG19Features:
    """A VGG19Features computing in `dtype` with the convolutions of a
    torchvision ``vgg19.features`` state_dict ({'0.weight', '0.bias', ...};
    torch tensors or numpy arrays). Entries past index 18 are ignored."""
    model = VGG19Features(dtype)
    sd = {}
    for i in CONVS:
        for kind in ("weight", "bias"):
            v = state_dict[f"{i}.{kind}"]
            sd[f"{i}.{kind}"] = v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v, np.float32))
    model.load_state_dict(sd)
    return model


def load_npz(path: str, dtype: torch.dtype = torch.float32) -> VGG19Features:
    """Load VGG19 feature weights from an .npz exported from torchvision."""
    with np.load(path) as data:
        return load_torch_state_dict(dict(data), dtype)
