"""The net: illumination-estimation encoder-decoder + multi-scale Retinex
enhancement head, in PyTorch (NCHW inside).

Counterpart of ``retinex_tpu/models/retinex_net.py``. ``MultiScaleUPRetinex``
takes and returns NHWC float images like the JAX module:
``(enhanced [B,H,W,3], reflectance [B,H,W,3], illumination [B,H,W,1])``.
H and W must be multiples of 8 (the encoder downsamples 8x).

``dtype`` is the compute dtype, as the JAX module's: in bf16 the layers
round as Flax's do (``models/layers.py``), and the f32 input and its mean
promote the outputs back to f32 as JAX promotes them (the illumination is
sigmoid(f32 mean + bf16 residual), the reflectance x / that, the enhanced
image the f32 reflectance times the bf16 enhancement map), so all three
come back f32.

``remat`` (``--remat``) checkpoints in training what the JAX module wraps
in ``nn.remat``: the IE-net's residual (or pre-activation) blocks and its
UpBlocks, and the three scale towers; not the ASPP, whose dropout draws
from its generator and would draw a second mask on a recomputation
(``layers.checkpointed``). The parameters and their names do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retinex_tpu_torch.models.layers import (
    ASPPModule,
    EnhancedFAM,
    PreActResBlock,
    ResBlock,
    UpBlock,
    checkpointed,
    conv,
)
from retinex_tpu_torch.ops import bf16
from retinex_tpu_torch.ops.resize import resize_bilinear_nchw


class ResidualIENet(nn.Module):
    """Residual illumination estimator: 3->32 stem, 3 stride-2 residual stages
    (64/128/256), bottleneck (2 res blocks, optional ASPP between), 3 UpBlocks
    with additive skips, residual head; illumination =
    sigmoid(mean_RGB(x) + residual)."""

    def __init__(
        self, use_preact: bool = False, use_aspp: bool = False, dtype: torch.dtype = torch.float32, remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        block = PreActResBlock if use_preact else ResBlock
        dt = dict(dtype=dtype)
        self.input_layer = conv(3, 32, 3, **dt)
        self.enc1 = block(32, 64, stride=2, **dt)
        self.enc2 = block(64, 128, stride=2, **dt)
        self.enc3 = block(128, 256, stride=2, **dt)
        middle = [block(256, 256, **dt)] + ([ASPPModule(256, 256, **dt)] if use_aspp else []) + [block(256, 256, **dt)]
        self.bottleneck = nn.Sequential(*middle)
        self.dec3 = UpBlock(256, 128, **dt)
        self.dec2 = UpBlock(128, 64, **dt)
        self.dec1 = UpBlock(64, 32, **dt)
        self.residual_head = nn.Sequential(conv(32, 32, 3, **dt), nn.ReLU(), conv(32, 1, 1, **dt))

    def _block(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A residual block or UpBlock, checkpointed with ``remat``."""
        return checkpointed(module, self.remat, x)

    def middle(self, x2: torch.Tensor) -> torch.Tensor:
        """enc2 -> inner -> dec2 with skip: the /2-and-below body."""
        return self._block(self.dec2, self.inner(self._block(self.enc2, x2))) + x2

    def inner(self, x3: torch.Tensor) -> torch.Tensor:
        """enc3 -> bottleneck (+ASPP) -> dec3 with skip: the /4-and-below
        body (models/packed_inference.py runs enc2/dec2 packed and calls
        this for the rest)."""
        y = self._block(self.enc3, x3)
        for m in self.bottleneck:
            y = m(y) if isinstance(m, ASPPModule) else self._block(m, y)
        return self._block(self.dec3, y) + x3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(self.input_layer(x))
        x2 = self._block(self.enc1, x1)
        d2 = self.middle(x2)
        d1 = self._block(self.dec1, d2) + x1
        residual = self.residual_head(d1)
        return bf16.sigmoid(x.mean(dim=1, keepdim=True) + residual)


def scale_tower(pool: int, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Per-scale feature tower: optional max-pool downsample, 3x3 conv + ReLU,
    EnhancedFAM (the reference's ``scale1`` / ``scale2`` / ``scale3``)."""
    head = [nn.MaxPool2d(pool)] if pool > 1 else []  # max_pool_nonneg(x, pool, pool)
    return nn.Sequential(*head, conv(3, 32, 3, dtype=dtype), nn.ReLU(), EnhancedFAM(32, dtype))


class MultiScaleUPRetinex(nn.Module):
    """Unsupervised physics-guided Retinex network with multi-scale enhancement.

    The flag defaults mirror the JAX module's (both on); the CLI's Config
    turns both off, as the JAX CLI does."""

    def __init__(
        self, use_preact: bool = True, use_aspp: bool = True, epsilon: float = 1e-6, dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.use_preact = use_preact
        self.use_aspp = use_aspp
        self.epsilon = epsilon
        self.dtype = dtype
        self.remat = remat
        self.ie_net = ResidualIENet(use_preact, use_aspp, dtype, remat)
        self.scale1 = scale_tower(1, dtype)
        self.scale2 = scale_tower(2, dtype)
        self.scale3 = scale_tower(4, dtype)
        self.fusion = conv(96, 32, 1, dtype=dtype)
        self.output_layer = conv(32, 3, 1, dtype=dtype)

    def forward_nchw(self, x: torch.Tensor):
        """x: [B,3,H,W] -> (enhanced, reflectance, illumination), NCHW."""
        illu = self.ie_net(x)
        reflectance = x / (illu + self.epsilon)
        h, w = x.shape[2], x.shape[3]
        # Bilinear half / quarter inputs with floor sizes int(h * scale).
        x2 = resize_bilinear_nchw(x, int(h * 0.5), int(w * 0.5))
        x3 = resize_bilinear_nchw(x, int(h * 0.25), int(w * 0.25))
        f1 = checkpointed(self.scale1, self.remat, x)
        f2 = resize_bilinear_nchw(checkpointed(self.scale2, self.remat, x2), h, w)
        f3 = resize_bilinear_nchw(checkpointed(self.scale3, self.remat, x3), h, w)
        e_map = bf16.sigmoid(self.output_layer(self.fusion(torch.cat([f1, f2, f3], dim=1))))
        enhanced = reflectance * e_map + (1.0 - reflectance) * (e_map * e_map)
        return enhanced, reflectance, illu

    def forward(self, x: torch.Tensor):
        """x: [B,H,W,3] float -> (enhanced, reflectance, illumination), NHWC."""
        outs = self.forward_nchw(x.permute(0, 3, 1, 2))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


def count_parameters(model: nn.Module) -> int:
    """Total number of parameters (BatchNorm statistics are buffers, not
    counted), as the JAX package's count over its params pytree."""
    return sum(p.numel() for p in model.parameters())
