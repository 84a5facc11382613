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
checkpoints. Across ranks (``parallel/distributed.py``) the batch
statistics are the global batch's (``batch_moments``), as the JAX step's
over its mesh, so every rank's running statistics move alike, and the
dropout mask is drawn for the global batch, each rank keeping its rows.

Each module takes a ``dtype``, the compute dtype of Flax's ``dtype=``: the
parameters stay f32, and in bf16 each layer rounds where Flax's forward
rounds (``ops/bf16.py``). A convolution rounds its sum, then adds its bias
in bf16; a BatchNorm widens its bf16 input to f32 and rounds its output
once: in eval mode ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` on
the running statistics (``flax/linen/normalization.py::_normalize``), in
train mode the same on the batch statistics, which Flax takes in f32 from
the input widened once more (``_compute_stats``,
``force_float32_reductions``; the two widenings' gradients each round to
bf16 before they add) and folds into f32 running statistics; a mean sums
in f32 and rounds once.
``torch.autocast`` rounds elsewhere (it keeps BatchNorm and reductions in
f32 and casts weights op by op), so it is not used. A sigmoid is XLA's 1 /
(1 + exp(-x)), each operation rounded. f32 runs the PyTorch modules as they
are. The gradients flow back through every rounding as ``jax.grad`` flows
through ``astype``: a bf16 tensor's gradient is bf16.

``remat`` (``--remat``) recomputes a block's activations in the backward
instead of keeping them (``torch.utils.checkpoint``, non-reentrant), as
Flax's ``nn.remat``: ``checkpointed`` wraps a module's call (or a packed
training stage) where the model is training and remat is on. The
recomputation runs ``BatchNorm.forward`` (or the packed step's
``_bn_train``) once more, so it must not update the running statistics a
second time (Flax's remat is functional and updates them once):
``recomputing()`` is on while ``torch.utils.checkpoint``
recomputes, and a training BatchNorm leaves its statistics alone then.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from retinex_tpu_torch.ops import bf16
from retinex_tpu_torch.parallel.distributed import all_reduce_sum, data_shard, data_world

BN_EPS = 1e-5
_RECOMPUTING = [False]


@contextlib.contextmanager
def _recomputation():
    _RECOMPUTING[0] = True
    try:
        yield
    finally:
        _RECOMPUTING[0] = False


def recomputing() -> bool:
    """Whether ``torch.utils.checkpoint`` is recomputing a block's forward
    (``checkpointed``) for the backward."""
    return _RECOMPUTING[0]


def checkpointed(fn, remat: bool, *args):
    """``fn(*args)``; with `remat` (and, where `fn` is a module, the module
    training), through ``torch.utils.checkpoint`` (non-reentrant), whose
    recomputation runs under ``recomputing()``. `fn` is a module of the net
    or a stage of the packed train forward (``models/packed_train.py``)."""
    if not (remat and getattr(fn, "training", True)):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=lambda: (contextlib.nullcontext(), _recomputation())
    )


def max_pool_nonneg(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool over H, W for non-negative inputs (post-ReLU features, [0,1]
    images). The JAX package pads with zeros; with inputs >= 0 and at least
    one real pixel in every window that equals PyTorch's -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


def batch_moments(xs: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """E[x] and E[x^2] of f32 `xs` over `dims`, the batch axis among them,
    taken over the global batch: ``mean`` as it always was in a world of one
    rank; across ranks (``parallel/distributed.py``) the two sums in one
    all-reduce, whose gradient is summed over the ranks too, over the global
    count."""
    world = data_world()
    if world == 1:
        return xs.mean(dim=dims), (xs * xs).mean(dim=dims)
    count = world
    for d in dims:
        count *= xs.shape[d]
    sums = all_reduce_sum(torch.stack([xs.sum(dim=dims), (xs * xs).sum(dim=dims)]))
    return sums[0] / count, sums[1] / count


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode computes and updates the batch
    statistics as Flax's BatchNorm does (module docstring); eval mode is
    ``nn.BatchNorm2d``'s in f32. In a reduced `dtype` both modes are Flax's
    on the input widened to f32, the output rounded to `dtype` once."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(ch, eps=BN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        reduced = self.compute_dtype != torch.float32
        if not (self.training or reduced):
            return super().forward(x)
        if self.training:
            # Flax widens x twice, for the statistics (_compute_stats) and
            # for the normalisation (_normalize): in bf16 each widening's
            # gradient rounds to bf16 before the two are added, as there.
            xs = x.float()
            mean, mean2 = batch_moments(xs, (0, 2, 3))
            # jnp.maximum: a tie at 0 passes half the gradient, as torch.maximum does.
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.compute_dtype) if reduced else y


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
        # Across ranks each draws the global batch's mask and keeps its rows.
        rank, world = data_shard()
        b = x.shape[0]
        u = torch.rand((b * world, *x.shape[1:]), generator=self.generator, device=x.device)
        keep = (u if world == 1 else u[rank * b : (rank + 1) * b]) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _bn(ch: int, dtype: torch.dtype = torch.float32) -> BatchNorm:
    return BatchNorm(ch, dtype)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in `dtype` as Flax's ``nn.Conv(dtype=...)``:
    x and the kernel rounded to it, the sum rounded once, then the bias
    added in it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.padded(x, self.padding)

    def padded(self, x: torch.Tensor, padding: tuple[int, int]) -> torch.Tensor:
        """The convolution with zero `padding` (rows, columns) in place of
        the module's own (the spatial forward's slabs carry their halo rows)."""
        if self.compute_dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding, self.dilation)
        y = bf16.conv2d(x.to(self.compute_dtype), self.weight, self.stride, padding, self.dilation)
        return bf16.add_bias(y, self.bias, nchw=True)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (stride = kernel, no padding) computing in
    `dtype` as Flax's ``nn.ConvTranspose(dtype=...)``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = bf16.conv_transpose2d(x.to(self.compute_dtype), self.weight, self.stride)
        return bf16.add_bias(y, self.bias, nchw=True)


class Sigmoid(nn.Module):
    """``jax.nn.sigmoid`` in the input's dtype (``ops/bf16.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bf16.sigmoid(x)


class MeanPool(nn.Module):
    """Global average pool to [B,C,1,1]: ``nn.AdaptiveAvgPool2d(1)`` in f32,
    ``jnp.mean`` (f32 sum, one rounding) in a reduced dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.adaptive_avg_pool2d(x, 1)
        return bf16.mean(x, (2, 3), keepdim=True)


def conv(
    cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1, bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Conv:
    """k x k conv with the JAX package's symmetric 'same' padding."""
    return Conv(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation, bias=bias, dtype=dtype)


def conv_bn_relu(
    cin: int, cout: int, k: int = 3, dilation: int = 1, bias: bool = False, dtype: torch.dtype = torch.float32,
) -> list[nn.Module]:
    return [conv(cin, cout, k, dilation=dilation, bias=bias, dtype=dtype), _bn(cout, dtype), nn.ReLU()]


class EnhancedFAM(nn.Module):
    """4-branch feature aggregation with channel + spatial attention."""

    def __init__(self, f: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.branch1 = conv(f, f, 1, dtype=dtype)
        self.branch2_conv = conv(f, f, 1, dtype=dtype)
        self.branch3_conv1 = conv(f, f, 3, dtype=dtype)
        self.branch3_conv2 = conv(f, f, 3, dtype=dtype)
        self.branch4_conv1 = conv(f, f, 3, dtype=dtype)
        self.branch4_conv2 = conv(f, f, 3, dilation=2, dtype=dtype)
        self.fusion = conv(4 * f, f, 1, dtype=dtype)
        self.channel_attention = nn.Sequential(
            MeanPool(), conv(f, f // 16, 1, dtype=dtype), nn.ReLU(), conv(f // 16, f, 1, dtype=dtype), Sigmoid()
        )
        self.spatial_attention = nn.Sequential(conv(2, 1, 7, dtype=dtype), Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1(x)
        b2 = self.branch2_conv(max_pool_nonneg(x, 3, 1, 1))
        b3 = self.branch3_conv2(F.relu(self.branch3_conv1(x)))
        b4 = self.branch4_conv2(F.relu(self.branch4_conv1(x)))
        out = F.relu(self.fusion(torch.cat([b1, b2, b3, b4], dim=1)))
        out = out * self.channel_attention(out)
        sa = torch.cat([bf16.mean(out, 1, keepdim=True), out.amax(dim=1, keepdim=True)], dim=1)
        return out * self.spatial_attention(sa)


class ResBlock(nn.Module):
    """Post-activation residual block, optional stride-2 downsample."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv(cin, features, 3, stride=stride, bias=False, dtype=dtype)
        self.bn1 = _bn(features, dtype)
        self.conv2 = conv(features, features, 3, bias=False, dtype=dtype)
        self.bn2 = _bn(features, dtype)
        self.shortcut = nn.Sequential()
        if stride != 1 or cin != features:
            self.shortcut = nn.Sequential(
                conv(cin, features, 1, stride=stride, bias=False, dtype=dtype), _bn(features, dtype)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.shortcut(x))


class PreActResBlock(nn.Module):
    """Pre-activation residual block; a projection shortcut is taken from the
    pre-activated tensor."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = _bn(cin, dtype)
        self.conv1 = conv(cin, features, 3, stride=stride, bias=False, dtype=dtype)
        self.bn2 = _bn(features, dtype)
        self.conv2 = conv(features, features, 3, bias=False, dtype=dtype)
        self.needs_proj = stride != 1 or cin != features
        self.shortcut = nn.Sequential()
        if self.needs_proj:
            self.shortcut = nn.Sequential(
                conv(cin, features, 1, stride=stride, bias=False, dtype=dtype), _bn(features, dtype)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        sc = self.shortcut(pre) if self.needs_proj else x
        y = F.relu(self.bn2(self.conv1(pre)))
        return self.conv2(y) + sc


class ASPPModule(nn.Module):
    """Atrous spatial pyramid pooling with a global-average-pool branch."""

    def __init__(
        self, cin: int, features: int, dilations: tuple[int, ...] = (1, 6, 12, 18), dropout: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.conv1x1 = nn.Sequential(*conv_bn_relu(cin, features, 1, dtype=dtype))
        self.aspp_branches = nn.ModuleList(
            nn.Sequential(*conv_bn_relu(cin, features, 3, dilation=d, dtype=dtype)) for d in dilations[1:]
        )
        self.global_pool = nn.Sequential(MeanPool(), *conv_bn_relu(cin, features, 1, dtype=dtype))
        n = len(dilations) + 1
        self.fusion = nn.Sequential(*conv_bn_relu(n * features, features, 1, dtype=dtype), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        feats = [self.conv1x1(x)] + [branch(x) for branch in self.aspp_branches]
        # Bilinear resize of a 1x1 map is a broadcast.
        feats.append(self.global_pool(x).expand(-1, -1, h, w))
        return self.fusion(torch.cat(feats, dim=1))


class UpBlock(nn.Module):
    """2x upsample: ConvTranspose(k2, s2) then two conv-BN-ReLU stages."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = ConvTranspose(cin, features, 2, stride=2, dtype=dtype)
        self.conv = nn.Sequential(
            *conv_bn_relu(features, features, 3, bias=True, dtype=dtype),
            *conv_bn_relu(features, features, 3, bias=True, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.up(x))
