"""Space-to-depth packed training for MultiScaleUPRetinex, in PyTorch.

Counterpart of ``retinex_tpu/models/packed_train.py``, the JAX package's
default training forward (``--packed_train``). The train-mode forward runs
with the full-resolution stages (the IENet's input conv and enc1, dec1 with
the residual head, the scale-1 tower, the fusion head) and the /2 stages
(enc2, dec2, the scale-2 tower) rewritten in packed space, 2x2 pixels to
channels, as ``models/packed_inference.py`` rewrites inference: narrow
convolutions and their backward convolutions run 4x wider. It computes the
standard train-mode forward's function up to float reassociation
(``tests/test_torch_packed_train.py``).

What differs from packed inference:

- The gradient flows to the model's own parameters, so the kernels are
  packed inside the step by the differentiable ``ops/s2d.pack_*_t`` (an
  einsum against a 0/1 placement tensor, in f32; a bf16 net packs in f32
  and rounds afterwards, as the JAX package does). The parameters, the
  optimizer, the checkpoints and ``--resume`` are the standard step's.
- BatchNorm runs in train mode on the packed tensors: the statistics of a
  packed [B,h,w,4C] tensor reduce over batch, packed space and the four
  quadrants (Flax's numerics: f32 E[x^2] - E[x]^2 clipped at 0, rsqrt, the
  output cast back once), and the running statistics of the model's own
  ``BatchNorm`` modules move by Flax's momentum 0.9, once a step (not
  while ``torch.utils.checkpoint`` recomputes, ``layers.recomputing()``).
- The FAMs are plain differentiable PyTorch: the FAM kernels (K4-K6) have
  no backward, and the JAX module runs XLA there too. The fusion applies
  its four per-branch row blocks added in the JAX order (in bf16 each add
  rounds), the channel attention's GAP is the mean over packed space and
  quadrants, and the spatial attention runs on the per-quadrant
  [avg | max] map through the packed 7x7 conv.

The /4-and-below body (``ResidualIENet.inner``: enc3, the bottleneck with
the ASPP and its dropout, dec3) and the scale-3 tower run through the
standard modules, so their BatchNorm statistics update in place and the
dropout draws its mask from the train state's generator once, in the
standard step's order. With ``remat`` (``--remat``) each of the six packed
stages (the full-res encode, enc2, dec2, dec1 with the illumination, the
two packed scale towers, the fusion head) runs under
``torch.utils.checkpoint`` (``layers.checkpointed``), and the standard
modules checkpoint their blocks as in the standard step.

Tensors are NHWC (packed channels quadrant-major, ``ops/s2d.py``); each
convolution hands ``F.conv2d`` a channels-last NCHW view (``conv_nhwc``).
H and W must be multiples of 32 (the trainer's gate, as the JAX trainer's).
"""

from __future__ import annotations

import torch
from torch import nn

from retinex_tpu_torch.models.layers import BN_EPS, batch_moments, checkpointed, recomputing
from retinex_tpu_torch.models.packed_inference import _interleave_packed, _nchw
from retinex_tpu_torch.ops import bf16
from retinex_tpu_torch.ops.resize import resize_bilinear, resize_scale
from retinex_tpu_torch.ops.s2d import (
    conv_nhwc,
    conv_s2d,
    d2s,
    maxpool3x3_s1_s2d,
    pack_convtranspose2_t,
    pack_kernel_s1_t,
    pack_kernel_s2_t,
    pack_pointwise_t,
    s2d,
    s2d_upsample_mxu,
)

_BN_MOMENTUM = 0.9  # Flax's momentum (the running statistics keep 0.9 of themselves)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A Conv2d's OIHW weight as an HWIO view (the packers' layout)."""
    return conv.weight.permute(2, 3, 1, 0)


def _hwio_transposed(up: nn.ConvTranspose2d) -> torch.Tensor:
    """A ConvTranspose2d's [I,O,kh,kw] weight as Flax's HWIO kernel, which
    is spatially flipped (``models/convert.py``)."""
    return up.weight.permute(2, 3, 0, 1).flip(0, 1)


def _tile4(v: torch.Tensor) -> torch.Tensor:
    """v's last axis repeated once per quadrant (``jnp.tile(v, 4)``)."""
    return v.repeat(*([1] * (v.ndim - 1)), 4)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A stride-1 Conv2d of the model as it is, on NHWC x."""
    return conv_nhwc(x, conv.weight, conv.bias, (conv.padding[0], conv.padding[0]), conv.dilation[0])


def _packed(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A stride-1 odd-k Conv2d of the model packed (a 1x1 block-diagonally)
    and run on packed x."""
    w = _hwio(conv)
    k = pack_pointwise_t(w) if w.shape[0] == 1 else pack_kernel_s1_t(w, conv.dilation[0])
    return conv_s2d(x, k, conv.bias)


def _bn_train(x: torch.Tensor, bn: nn.BatchNorm2d, phases: int = 1) -> torch.Tensor:
    """Train-mode BatchNorm of `bn`'s parameters on NHWC x, or on a packed
    x with `phases` = 4 (channels as (quadrant, channel) blocks, the
    statistics reduced over the quadrants too). Flax's numerics: x widened
    to f32 once, E[x^2] - E[x]^2 clipped at 0, rsqrt, the output cast back
    to x.dtype; `bn`'s running statistics updated unless recomputing."""
    xf = x.float()
    xr = xf.reshape(*x.shape[:-1], phases, x.shape[-1] // phases)
    mean, mean2 = batch_moments(xr, tuple(range(xr.ndim - 1)))
    # jnp.maximum: a tie at 0 passes half the gradient, as torch.maximum does.
    var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
    if not recomputing():
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean + (1.0 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var + (1.0 - _BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (xf - mean.repeat(phases)) * mul.repeat(phases) + bn.bias.repeat(phases)
    return y.to(x.dtype)


def _enc_block_train(xp: torch.Tensor, blk: nn.Module, use_preact: bool) -> torch.Tensor:
    """A stride-2 (PreAct)ResBlock on packed input [*, 4Cin] -> unpacked
    [*, Cout] at the packed resolution: conv1 and the 1x1 shortcut packed
    to stride-1 convolutions, conv2 as it is."""
    k_conv1 = pack_kernel_s2_t(_hwio(blk.conv1))
    k_short = pack_kernel_s2_t(_hwio(blk.shortcut[0]))
    short_bn = blk.shortcut[1]
    if use_preact:
        pre = torch.relu(_bn_train(xp, blk.bn1, phases=4))
        short = _bn_train(conv_s2d(pre, k_short), short_bn)
        y = torch.relu(_bn_train(conv_s2d(pre, k_conv1), blk.bn2))
        return _conv(y, blk.conv2) + short
    y = torch.relu(_bn_train(conv_s2d(xp, k_conv1), blk.bn1))
    y = _bn_train(_conv(y, blk.conv2), blk.bn2)
    short = _bn_train(conv_s2d(xp, k_short), short_bn)
    return torch.relu(y + short)


def _up_block_train(d: torch.Tensor, blk: nn.Module) -> torch.Tensor:
    """An UpBlock from unpacked input to PACKED 2x-resolution output
    [*, 4Cout]: the k2s2 transposed conv as a packed pointwise conv, the
    two 3x3 conv-BN-ReLU stages packed."""
    y = conv_s2d(d, pack_convtranspose2_t(_hwio_transposed(blk.up)), blk.up.bias)
    for conv, bn in ((blk.conv[0], blk.conv[1]), (blk.conv[3], blk.conv[4])):
        y = torch.relu(_bn_train(_packed(y, conv), bn, phases=4))
    return y


def _fam_train(xp: torch.Tensor, fam: nn.Module, c: int = 32) -> torch.Tensor:
    """EnhancedFAM on packed [*, 4c] input, plain differentiable PyTorch."""
    b1 = _packed(xp, fam.branch1)
    b2 = _packed(maxpool3x3_s1_s2d(xp), fam.branch2_conv)
    b3 = _packed(torch.relu(_packed(xp, fam.branch3_conv1)), fam.branch3_conv2)
    b4 = _packed(torch.relu(_packed(xp, fam.branch4_conv1)), fam.branch4_conv2)

    # fusion(cat(b1..b4)) as its four per-branch row blocks, added in order.
    kfu = _hwio(fam.fusion)  # [1,1,4c,c], input rows ordered (branch, c)
    p = [conv_s2d(b, pack_pointwise_t(kfu[:, :, c * i : c * (i + 1), :])) for i, b in enumerate((b1, b2, b3, b4))]
    out = torch.relu(p[0] + p[1] + p[2] + p[3] + _tile4(fam.fusion.bias).to(b1.dtype))

    # Channel attention: the per-channel GAP is the mean over packed space
    # and quadrants (equal counts, so the mean of the means is exact).
    bsz, hh, ww, _ = out.shape
    gap = bf16.mean(bf16.mean(out, (1, 2)).reshape(bsz, 4, c), 1)[:, None, None, :]
    ca = torch.relu(_conv(gap, fam.channel_attention[1]))
    ca = bf16.sigmoid(_conv(ca, fam.channel_attention[3]))
    out = out * _tile4(ca).to(out.dtype)

    # Spatial attention per original pixel, on the packed quadrant map.
    blocks = out.reshape(bsz, hh, ww, 4, c)
    sa_in = torch.stack([bf16.mean(blocks, -1), blocks.amax(dim=-1)], dim=-1).reshape(bsz, hh, ww, 8)
    sa = bf16.sigmoid(_packed(sa_in, fam.spatial_attention[0]))
    return (blocks * sa[..., None]).reshape(bsz, hh, ww, 4 * c)


def _upsample_packed(g: torch.Tensor, factor: int, h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
    """s2d(resize_bilinear(g, h, w)) in `dtype`: the matrix-product phase
    upsample where the shapes refold exactly (always, for /32 inputs)."""
    if factor * g.shape[1] == h and factor * g.shape[2] == w:
        return s2d_upsample_mxu(g, factor).to(dtype)
    return s2d(resize_bilinear(g, h, w)).to(dtype)


def packed_train_apply(model: nn.Module, x: torch.Tensor):
    """The train-mode forward of `model` (a ``MultiScaleUPRetinex`` in train
    mode), packed: x [B,H,W,3] float [0,1], H and W multiples of 32 ->
    (enhanced, reflectance, illumination), NHWC, as ``model(x)`` returns
    them up to float reassociation; the BatchNorm running statistics
    update in place, once. With ``model.remat`` the six packed stages run
    under ``torch.utils.checkpoint``."""
    dtype, ie, preact = model.dtype, model.ie_net, model.use_preact

    def stage(fn, *args):
        return checkpointed(fn, model.remat, *args)

    def full_res_encode(xp_):
        x1p_ = torch.relu(_packed(xp_, ie.input_layer))
        return x1p_, _enc_block_train(x1p_, ie.enc1, preact)

    def dec1_illu(d2_, x1p_, x_):
        d1p_ = _up_block_train(d2_, ie.dec1) + x1p_
        r_ = torch.relu(_packed(d1p_, ie.residual_head[0]))
        res_p_ = _packed(r_, ie.residual_head[2])
        mean_p_ = s2d(x_.mean(dim=-1, keepdim=True))  # f32, as the JAX module's
        return d2s(bf16.sigmoid(mean_p_ + res_p_))

    def tower(conv, fam):
        return lambda inp: _fam_train(torch.relu(_packed(inp, conv)), fam)

    h, w = x.shape[1], x.shape[2]

    def fusion_head(f1p_, f2p_, f3_):
        f2ps_ = _upsample_packed(d2s(f2p_), 4, h, w, dtype)
        f3ps_ = _upsample_packed(f3_, 16, h, w, dtype)
        fused_ = _packed(_interleave_packed([f1p_, f2ps_, f3ps_], 32), model.fusion)
        return d2s(bf16.sigmoid(_packed(fused_, model.output_layer)))

    xp = s2d(x).to(dtype)
    x1p, x2 = stage(full_res_encode, xp)
    # enc2 and dec2 packed; the /4-and-below body through the modules.
    x2p = s2d(x2)
    x3 = stage(lambda a: _enc_block_train(a, ie.enc2, preact), x2p)
    d3 = _nchw(ie.inner, x3)
    d2 = d2s(stage(lambda a: _up_block_train(a, ie.dec2), d3) + x2p)
    illu = stage(dec1_illu, d2, x1p, x)
    reflectance = x / (illu + model.epsilon)

    # Scale towers: scale1 and scale2 packed, scale3 (1/16, tiny) as it is.
    f1p = stage(tower(model.scale1[0], model.scale1[2]), xp)
    x2sp = s2d(resize_scale(x, 0.5).to(dtype))
    pooled = x2sp.reshape(*x2sp.shape[:3], 4, 3).amax(dim=3)  # the 2x2/s2 max pool
    f2p = stage(tower(model.scale2[1], model.scale2[3]), s2d(pooled))
    f3 = _nchw(lambda t: checkpointed(model.scale3, model.remat, t), resize_scale(x, 0.25))

    e_map = stage(fusion_head, f1p, f2p, f3)
    enhanced = reflectance * e_map + (1.0 - reflectance) * (e_map * e_map)
    return enhanced, reflectance, illu
