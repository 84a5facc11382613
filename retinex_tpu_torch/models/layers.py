"""Building-block modules of the net (NCHW), in PyTorch.

Counterpart of ``retinex_tpu/models/layers.py``. Module and parameter names
follow the reference PyTorch checkpoints that ``retinex_tpu/models/convert.py``
reads (``shortcut.0``, ``conv.3``, ``aspp_branches.1.0``, ...), so a
reference ``.pth`` loads straight through ``load_state_dict`` and
``models/convert.py`` maps Flax variables onto the same names.

In ``.eval()`` BatchNorm runs on its running statistics (eps 1e-5) and
dropout is off, as in the JAX package's ``train=False`` forward.
``PackedRetinex`` reads those same buffers. In ``.train()`` they follow
Flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9)``, as the
JAX package's ``train=True`` forward does: the batch variance is the biased
``max(0, E[x^2] - E[x]^2)`` over N, H and W, it normalises the batch, and
the running statistics become ``0.9 * running + 0.1 * batch``. PyTorch's
``nn.BatchNorm2d`` would put the unbiased variance (divided by n - 1) into
``running_var``, which at a 4x4 map of a batch of 2 (32 values) is 3 % off,
and would compute it in another way. The one dropout (ASPP's) draws its
mask from an explicit ``torch.Generator``, which the trainer seeds and
checkpoints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def max_pool_nonneg(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool over H, W for non-negative inputs (post-ReLU features, [0,1]
    images). The JAX package pads with zeros; with inputs >= 0 and at least
    one real pixel in every window that equals PyTorch's -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode computes and updates the batch
    statistics as Flax's BatchNorm does (module docstring); eval mode is
    ``nn.BatchNorm2d``'s."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        mean2 = (x * x).mean(dim=(0, 2, 3))
        # jnp.maximum: a tie at 0 passes half the gradient, as torch.maximum does.
        var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class Dropout(nn.Module):
    """Dropout whose mask comes from ``self.generator`` (a ``torch.Generator``
    on the input's device, or the default generator when None): Flax's
    ``nn.Dropout``, keep with probability 1 - p and scale by 1 / (1 - p)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch)


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1, bias: bool = True) -> nn.Conv2d:
    """k x k conv with the JAX package's symmetric 'same' padding."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation, bias=bias)


def conv_bn_relu(cin: int, cout: int, k: int = 3, dilation: int = 1, bias: bool = False) -> list[nn.Module]:
    return [conv(cin, cout, k, dilation=dilation, bias=bias), _bn(cout), nn.ReLU()]


class EnhancedFAM(nn.Module):
    """4-branch feature aggregation with channel + spatial attention."""

    def __init__(self, f: int):
        super().__init__()
        self.branch1 = conv(f, f, 1)
        self.branch2_conv = conv(f, f, 1)
        self.branch3_conv1 = conv(f, f, 3)
        self.branch3_conv2 = conv(f, f, 3)
        self.branch4_conv1 = conv(f, f, 3)
        self.branch4_conv2 = conv(f, f, 3, dilation=2)
        self.fusion = conv(4 * f, f, 1)
        self.channel_attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), conv(f, f // 16, 1), nn.ReLU(), conv(f // 16, f, 1), nn.Sigmoid()
        )
        self.spatial_attention = nn.Sequential(conv(2, 1, 7), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1(x)
        b2 = self.branch2_conv(max_pool_nonneg(x, 3, 1, 1))
        b3 = self.branch3_conv2(F.relu(self.branch3_conv1(x)))
        b4 = self.branch4_conv2(F.relu(self.branch4_conv1(x)))
        out = F.relu(self.fusion(torch.cat([b1, b2, b3, b4], dim=1)))
        out = out * self.channel_attention(out)
        sa = torch.cat([out.mean(dim=1, keepdim=True), out.amax(dim=1, keepdim=True)], dim=1)
        return out * self.spatial_attention(sa)


class ResBlock(nn.Module):
    """Post-activation residual block, optional stride-2 downsample."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, features, 3, stride=stride, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = conv(features, features, 3, bias=False)
        self.bn2 = _bn(features)
        self.shortcut = nn.Sequential()
        if stride != 1 or cin != features:
            self.shortcut = nn.Sequential(conv(cin, features, 1, stride=stride, bias=False), _bn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.shortcut(x))


class PreActResBlock(nn.Module):
    """Pre-activation residual block; a projection shortcut is taken from the
    pre-activated tensor."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.bn1 = _bn(cin)
        self.conv1 = conv(cin, features, 3, stride=stride, bias=False)
        self.bn2 = _bn(features)
        self.conv2 = conv(features, features, 3, bias=False)
        self.needs_proj = stride != 1 or cin != features
        self.shortcut = nn.Sequential()
        if self.needs_proj:
            self.shortcut = nn.Sequential(conv(cin, features, 1, stride=stride, bias=False), _bn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        sc = self.shortcut(pre) if self.needs_proj else x
        y = F.relu(self.bn2(self.conv1(pre)))
        return self.conv2(y) + sc


class ASPPModule(nn.Module):
    """Atrous spatial pyramid pooling with a global-average-pool branch."""

    def __init__(self, cin: int, features: int, dilations: tuple[int, ...] = (1, 6, 12, 18), dropout: float = 0.1):
        super().__init__()
        self.conv1x1 = nn.Sequential(*conv_bn_relu(cin, features, 1))
        self.aspp_branches = nn.ModuleList(
            nn.Sequential(*conv_bn_relu(cin, features, 3, dilation=d)) for d in dilations[1:]
        )
        self.global_pool = nn.Sequential(nn.AdaptiveAvgPool2d(1), *conv_bn_relu(cin, features, 1))
        n = len(dilations) + 1
        self.fusion = nn.Sequential(*conv_bn_relu(n * features, features, 1), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        feats = [self.conv1x1(x)] + [branch(x) for branch in self.aspp_branches]
        # Bilinear resize of a 1x1 map is a broadcast.
        feats.append(self.global_pool(x).expand(-1, -1, h, w))
        return self.fusion(torch.cat(feats, dim=1))


class UpBlock(nn.Module):
    """2x upsample: ConvTranspose(k2, s2) then two conv-BN-ReLU stages."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, features, 2, stride=2)
        self.conv = nn.Sequential(
            *conv_bn_relu(features, features, 3, bias=True), *conv_bn_relu(features, features, 3, bias=True)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.up(x))
