"""Space-to-depth packed inference for MultiScaleUPRetinex, in PyTorch.

Counterpart of ``retinex_tpu/models/packed_inference.py``. The same weights
are evaluated with the full-resolution stages (IENet input conv, enc1, dec1,
residual head, the scale-1 tower with its FAM, fusion and output head)
rewritten in packed space, 2x2 pixels to channels, and the /2 stages (enc2,
dec2) packed the same way at /4. Exact up to float reassociation; held to
the JAX package by ``tests/test_torch_packed.py``. The /4-and-below body
(``ResidualIENet.inner``) and the scale-3 tower run through the standard
modules.

The scale-1 and scale-2 FAMs run on the FAM kernels (``ops/fused_blocks.py``):
K4 for the whole conv stage (three launches on the card, its weights packed
once here), then channel attention, K5, the packed SA conv
and sigmoid, and K6, which folds the tower's fusion slice in. Where the
fusion does not fold (H or W not a multiple of 16, as a 1080-row frame
without ``--max_size``), K11 applies the attention instead of K6. On a CUDA
tensor the route always launches the kernels; on a CPU tensor the wrappers
take their plain versions.

A bf16 model (``MultiScaleUPRetinex(dtype=torch.bfloat16)``, ``--use_amp``)
runs the packed forward in bf16 as the JAX package's does on its kernel
route: the weights are rounded to bf16 once here, each ``_Conv`` and
``_Affine`` computes in the activation's dtype (a convolution's sum and its
bias each rounded, an affine's product and its sum each rounded), the means
sum in f32 and round once, and the FAMs run the kernels' bf16 instances, K4
from folds made in f32 and rounded once (``pack_fam_conv``). The enhanced
image and the reflectance come back f32, the illumination bf16, as JAX's.

``NetCfg(dec1_chain=True)`` runs the dec1 UpBlock, the +x1p residual and
the residual head's 3x3 conv as K10 (four launches on the card, its weights
packed once here), with the BatchNorm affines folded into the conv weights
in f32 (and, for a bf16 model, rounded to bf16 once, as the JAX kernel
casts its f32 folds); off by default, as in the JAX package. The kernels
take any shape, so the JAX package's tile gate (``dec1_chain_supported``)
has no counterpart; its CPU route never takes K10 (it runs the XLA chain,
whose bf16 instance rounds dec1's output before it adds x1p), while the
port's CPU route runs K10's plain version, the kernel's roundings. The JAX
``NetCfg``'s other fields have no counterpart, because each chose between TPU formulations of
one function that the port computes one way: ``fam_conv_fused`` and ``fam_tail_fold`` (the port always runs
K4-K6), ``fam_fused_max_batch`` (the kernels take any batch),
``fam_xla_folded`` (the XLA FAM when that batch gate is off),
``packed_scale2`` (the scale-2 tower is always packed where it halves
evenly), ``planar_sa`` and ``ups_mode`` (TPU layouts of the SA conv and
the upsample einsums), ``aspp_dots`` (a TPU formulation of the ASPP
convs), and the ``RETINEX_NO_FUSED`` switch that turned the Pallas calls
off. No CLI flag selects a ``NetCfg``; the JAX package has none either.

Usage::

    packed = PackedRetinex(model)          # model: MultiScaleUPRetinex, eval mode
    enhanced, reflectance, illu = packed(x)  # NHWC float [0,1], H and W even
    fused = PackedRetinex(model, NetCfg(dec1_chain=True))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import bf16
from retinex_tpu_torch.ops.fused_blocks import (
    FamConvPacked,
    TailG1Packed,
    dec1_chain,
    fam_conv_fused,
    pack_dec1_chain,
    pack_fam_conv,
    pack_tail_g1,
    fam_tail_apply,
    fam_tail_apply_g1,
    fam_tail_stats,
)
from retinex_tpu_torch.ops.resize import resize_bilinear, resize_scale
from retinex_tpu_torch.ops.s2d import (
    conv_nhwc,
    d2s,
    hwio_to_oihw,
    pack_kernel_s1,
    pack_kernel_s2,
    pack_pointwise,
    packed_pad,
    s2d,
    s2d_upsample_mxu,
    tile_bias,
)


@dataclasses.dataclass(frozen=True)
class NetCfg:
    """Kernel choices of PackedRetinex (the JAX ``NetCfg``'s one field that
    has a counterpart here; see the module docstring)."""

    dec1_chain: bool = False  # dec1 UpBlock + residual + residual_conv as K10


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _hwio(conv: nn.Conv2d) -> np.ndarray:
    """A Conv2d's OIHW weight as an HWIO numpy array (the packers' layout)."""
    return _np(conv.weight).transpose(2, 3, 1, 0)


def _tile4(v: np.ndarray) -> np.ndarray:
    return np.tile(v, 4)


def _bn_affine(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as per-channel (scale, bias), f32 on the CPU."""
    w, b = bn.weight.detach().cpu().float(), bn.bias.detach().cpu().float()
    mean, var = bn.running_mean.detach().cpu().float(), bn.running_var.detach().cpu().float()
    scale = w / torch.sqrt(var + bn.eps)
    return scale, b - mean * scale


@dataclasses.dataclass(frozen=True)
class _Affine:
    """y * scale + bias per channel (an inference BatchNorm), in the dtype
    that scale and bias are held in (the JAX package's ``_affine``: a bf16
    product and a bf16 sum, each rounded)."""

    scale: torch.Tensor
    bias: torch.Tensor

    @staticmethod
    def of(bn: nn.BatchNorm2d, device, tile: bool = False, dtype: torch.dtype = torch.float32) -> "_Affine":
        scale, bias = _bn_affine(bn)
        if tile:  # a BatchNorm on a packed tensor: one copy per quadrant
            scale, bias = scale.repeat(4), bias.repeat(4)
        return _Affine(scale.to(device, dtype), bias.to(device, dtype))

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.scale + self.bias


@dataclasses.dataclass(frozen=True)
class _Conv:
    """A stride-1 convolution on NHWC tensors, weight held as OIHW in the
    compute dtype (``conv_nhwc`` rounds as the JAX package's ``_conv`` in
    a reduced one)."""

    weight: torch.Tensor
    bias: torch.Tensor | None
    pad: tuple[int, int]
    dilation: int = 1

    @staticmethod
    def packed(kernel: np.ndarray, bias, device, dtype: torch.dtype = torch.float32) -> "_Conv":
        """A packed HWIO kernel; `bias` (numpy or None) is the original
        [Cout] bias, tiled per quadrant to the packed width. Both rounded
        to `dtype` once."""
        w = hwio_to_oihw(kernel)
        b = None if bias is None else tile_bias(torch.as_tensor(np.asarray(bias, np.float32)), w.shape[0])
        return _Conv(
            w.to(device, dtype).contiguous(memory_format=torch.channels_last),
            None if b is None else b.to(device, dtype),
            packed_pad(w.shape[2]),
        )

    @staticmethod
    def plain(conv: nn.Conv2d, dtype: torch.dtype = torch.float32) -> "_Conv":
        """A stride-1 Conv2d of the model as it is (symmetric padding)."""
        assert conv.stride == (1, 1)
        bias = None if conv.bias is None else conv.bias.detach().to(dtype)
        w = conv.weight.detach().to(dtype).contiguous(memory_format=torch.channels_last)
        return _Conv(w, bias, (conv.padding[0], conv.padding[0]), conv.dilation[0])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, self.pad, self.dilation)


@dataclasses.dataclass(frozen=True)
class _PackedFam:
    """An EnhancedFAM's weights folded for the FAM kernels.

    K4 takes ka, kb (the branch 1/2 1x1s times their fusion row blocks),
    k1/b1 (the branch 3/4 first convs stacked to 256 outputs), k32/k42 (the
    second convs times their fusion row blocks; branch 4's dilation-2 conv
    packs to dense taps) and bias_total (every constant term); the channel
    attention runs unpacked on the GAP vector; `sa` is the packed 7x7 SA
    conv (5x5 packed taps, 8 -> 4 channels); `conv` is ``pack_fam_conv`` of
    K4's seven tensors here, made once: they and their kernel layouts."""

    ka: torch.Tensor
    kb: torch.Tensor
    k1: torch.Tensor
    b1: torch.Tensor
    k32: torch.Tensor
    k42: torch.Tensor
    bias_total: torch.Tensor
    ca_w1: torch.Tensor
    ca_b1: torch.Tensor
    ca_w2: torch.Tensor
    ca_b2: torch.Tensor
    sa: _Conv
    conv: FamConvPacked


def _pack_fam(fam: nn.Module, device, dtype: torch.dtype = torch.float32) -> _PackedFam:
    """Fold an EnhancedFAM for packed evaluation. The fusion 1x1 splits into
    per-branch row blocks, fusion(cat4(b1..b4)) == sum_i b_i @ W_i, and each
    block commutes into its branch (a pointwise conv after a conv is a conv
    with transformed outputs). The weight x weight folds are f32 products
    on the CPU (numpy), once, so no reduced-precision matmul mode can touch
    them. In bf16 the channel attention's weights are rounded to bf16 here,
    and K4's folds are packed for its bf16 instance, rounded once."""
    bias = {name: _np(getattr(fam, name).bias) for name in (
        "branch1", "branch2_conv", "branch3_conv1", "branch3_conv2", "branch4_conv1", "branch4_conv2", "fusion",
    )}
    kfu = _hwio(fam.fusion)  # [1,1,4c,c], input rows (branch, c)
    c = kfu.shape[-1]
    wf = [pack_pointwise(kfu[:, :, c * i : c * (i + 1), :])[0, 0] for i in range(4)]

    def fold3(kernel: np.ndarray, w: np.ndarray) -> np.ndarray:
        return (kernel.reshape(-1, kernel.shape[-1]) @ w).reshape(kernel.shape[:3] + (w.shape[1],))

    ka = pack_pointwise(_hwio(fam.branch1))[0, 0] @ wf[0]
    kb = pack_pointwise(_hwio(fam.branch2_conv))[0, 0] @ wf[1]
    k32f = fold3(pack_kernel_s1(_hwio(fam.branch3_conv2)), wf[2])
    k42f = fold3(pack_kernel_s1(_hwio(fam.branch4_conv2), dilation=2), wf[3])
    bias_total = (
        _tile4(bias["fusion"])
        + _tile4(bias["branch1"]) @ wf[0]
        + _tile4(bias["branch2_conv"]) @ wf[1]
        + _tile4(bias["branch3_conv2"]) @ wf[2]
        + _tile4(bias["branch4_conv2"]) @ wf[3]
    )
    dual_k1 = np.concatenate(
        [pack_kernel_s1(_hwio(fam.branch3_conv1)), pack_kernel_s1(_hwio(fam.branch4_conv1))], axis=-1
    )
    dual_b1 = np.concatenate([_tile4(bias["branch3_conv1"]), _tile4(bias["branch4_conv1"])])
    ca_reduce, ca_expand = fam.channel_attention[1], fam.channel_attention[3]
    sa_conv = fam.spatial_attention[0]

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    k4 = {
        "ka": dev(ka), "kb": dev(kb), "k1": dev(dual_k1), "b1": dev(dual_b1), "k32": dev(k32f), "k42": dev(k42f),
        "bias_total": dev(bias_total),
    }
    return _PackedFam(
        **k4,
        ca_w1=dev(_hwio(ca_reduce)[0, 0]).to(dtype), ca_b1=dev(_np(ca_reduce.bias)).to(dtype),
        ca_w2=dev(_hwio(ca_expand)[0, 0]).to(dtype), ca_b2=dev(_np(ca_expand.bias)).to(dtype),
        sa=_Conv.packed(pack_kernel_s1(_hwio(sa_conv)), _np(sa_conv.bias), device, dtype),
        conv=pack_fam_conv(**k4, dtype=dtype),
    )


def _pack_convtranspose2(weight: torch.Tensor) -> np.ndarray:
    """PyTorch ConvTranspose2d(k2, s2): out(2I+c, 2J+d, o) = sum_i
    W[i,o,c,d] x(I,J,i) + b -> a packed pointwise kernel emitting quadrant
    (c, d): [Cin,Cout,2,2] -> HWIO [1,1,Cin,4*Cout]."""
    w = _np(weight)
    cin, cout = w.shape[0], w.shape[1]
    out = np.zeros((1, 1, cin, 4 * cout), np.float32)
    for c in range(2):
        for d in range(2):
            out[0, 0, :, (c * 2 + d) * cout : (c * 2 + d + 1) * cout] = w[:, :, c, d]
    return out


def _interleave_packed(tensors: list[torch.Tensor], c: int) -> torch.Tensor:
    """Concatenate packed tensors per quadrant block (so a block-diagonal
    packed pointwise kernel sees the [q, cat(channels)] layout)."""
    b, h, w, _ = tensors[0].shape
    parts = [t.reshape(b, h, w, 4, c) for t in tensors]
    return torch.cat(parts, dim=-1).reshape(b, h, w, 4 * c * len(tensors))


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """Run a standard (NCHW) module of the model on an NHWC tensor."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PackedRetinex:
    """Packed-inference wrapper around a MultiScaleUPRetinex in eval mode,
    its packed and folded weights held on the model's device."""

    def __init__(self, model: MultiScaleUPRetinex, cfg: NetCfg | None = None):
        self.model = model
        self.cfg = cfg or NetCfg()
        self.use_preact = model.use_preact
        self.dtype = dt = model.dtype
        device = next(model.parameters()).device
        ie = model.ie_net

        self.input = _Conv.packed(pack_kernel_s1(_hwio(ie.input_layer)), _np(ie.input_layer.bias), device, dt)
        self.enc1 = self._pack_down(ie.enc1, device)
        self.enc2 = self._pack_down(ie.enc2, device)
        self.dec1 = self._pack_up(ie.dec1, device, dt)
        self.dec2 = self._pack_up(ie.dec2, device, dt)
        res_conv, res_out = ie.residual_head[0], ie.residual_head[2]
        self.rescv = _Conv.packed(pack_kernel_s1(_hwio(res_conv)), _np(res_conv.bias), device, dt)
        self.resout = _Conv.packed(pack_pointwise(_hwio(res_out)), _np(res_out.bias), device, dt)
        if self.cfg.dec1_chain:
            self.dec1_fused = self._fold_dec1(ie.dec1, res_conv, device)
            self.dec1_packed = pack_dec1_chain(*self.dec1_fused, dt)  # K10's kernel layouts, once

        s1conv, s2conv = model.scale1[0], model.scale2[1]
        self.s1conv = _Conv.packed(pack_kernel_s1(_hwio(s1conv)), _np(s1conv.bias), device, dt)
        self.fam1 = _pack_fam(model.scale1[2], device, dt)
        # scale2's tower is the same narrow-conv shape at half resolution
        # (pool-2 -> 32ch conv + FAM), packed the same way.
        self.s2conv = _Conv.packed(pack_kernel_s1(_hwio(s2conv)), _np(s2conv.bias), device, dt)
        self.fam2 = _pack_fam(model.scale2[3], device, dt)

        # Fusion commuted with the upsamples: fusion(cat(f1, up(f2), up(f3)))
        # = W1@f1 + up(W2@f2) + up(W3@f3) (a 1x1 conv and a bilinear resize
        # are both linear), so the scale-2/3 slices run at low resolution and
        # the scale-1/2 slices fold into their FAM tails (K6).
        kf = _hwio(model.fusion)  # [1,1,96,32]
        self.fusion = _Conv.packed(pack_pointwise(kf), _np(model.fusion.bias), device, dt)
        self.b_fusion = torch.as_tensor(_tile4(_np(model.fusion.bias))).to(device, dt)
        # K6's weights, packed once: quadrant-block-diagonal, so the kernel's
        # diagonal instance serves them. They stay f32 in bf16 too, as the
        # JAX kernel takes them.
        self.fold_f1 = pack_tail_g1(torch.as_tensor(pack_pointwise(kf[:, :, 0:32, :])[0, 0]).to(device))
        self.fold_f2 = pack_tail_g1(torch.as_tensor(pack_pointwise(kf[:, :, 32:64, :])[0, 0]).to(device))
        self.w_fusion_f3 = torch.as_tensor(np.ascontiguousarray(kf[0, 0, 64:96, :])).to(device, dt)
        out = model.output_layer
        self.output = _Conv.packed(pack_pointwise(_hwio(out)), _np(out.bias), device, dt)

    # ---------- packing of the IENet's full-resolution and /2 blocks ----------

    def _pack_down(self, blk: nn.Module, device) -> dict:
        """A stride-2 (PreAct)ResBlock on a packed input: conv1 and the 1x1
        shortcut pack to stride-1 convs whose output is the original
        stride-2 output, unpacked; conv2 runs as it is."""
        short_conv, short_bn = blk.shortcut[0], blk.shortcut[1]
        dt = self.dtype
        return {
            "conv1": _Conv.packed(pack_kernel_s2(_hwio(blk.conv1)), None, device, dt),
            "short": _Conv.packed(pack_kernel_s2(_hwio(short_conv)), None, device, dt),
            "conv2": _Conv.plain(blk.conv2, dt),
            "bn1": _Affine.of(blk.bn1, device, tile=self.use_preact, dtype=dt),
            "bn2": _Affine.of(blk.bn2, device, dtype=dt),
            "short_bn": _Affine.of(short_bn, device, dtype=dt),
        }

    @staticmethod
    def _pack_up(blk: nn.Module, device, dtype: torch.dtype = torch.float32) -> dict:
        """An UpBlock from an unpacked input to a packed output: the k2s2
        transposed conv is a packed pointwise conv; the two 3x3 conv-BN-ReLU
        stages pack as stride-1 convs."""
        c1, bn1, c2, bn2 = blk.conv[0], blk.conv[1], blk.conv[3], blk.conv[4]
        return {
            "up": _Conv.packed(_pack_convtranspose2(blk.up.weight), _np(blk.up.bias), device, dtype),
            "convs": [
                (_Conv.packed(pack_kernel_s1(_hwio(c)), _np(c.bias), device, dtype),
                 _Affine.of(bn, device, tile=True, dtype=dtype))
                for c, bn in ((c1, bn1), (c2, bn2))
            ],
        }

    @staticmethod
    def _fold_dec1(blk: nn.Module, res_conv: nn.Conv2d, device) -> tuple[torch.Tensor, ...]:
        """K10's arguments after d2 and x1p, all f32: the packed dec1 weights
        with each BatchNorm folded in, k' = k * tile4(scale) and b' =
        tile4(b * scale + shift) (the inference BatchNorm's f32 scale and
        shift, tiled per quadrant), then the packed residual_conv."""
        c1, bn1, c2, bn2 = blk.conv[0], blk.conv[1], blk.conv[3], blk.conv[4]
        args = [_pack_convtranspose2(blk.up.weight), _tile4(_np(blk.up.bias))]
        for conv, bn in ((c1, bn1), (c2, bn2)):
            scale, shift = (_tile4(t.numpy()) for t in _bn_affine(bn))
            args += [pack_kernel_s1(_hwio(conv)) * scale, _tile4(_np(conv.bias)) * scale + shift]
        args += [pack_kernel_s1(_hwio(res_conv)), _tile4(_np(res_conv.bias))]
        return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device) for a in args)

    # ---------- packed building blocks ----------

    def _down(self, p: dict, xp: torch.Tensor) -> torch.Tensor:
        """enc1 (packed full-res input -> unpacked [B,H/2,W/2,64]) or enc2
        (packed [B,H/4,W/4,256] -> unpacked [B,H/4,W/4,128])."""
        if self.use_preact:
            pre = torch.relu(p["bn1"](xp))
            short = p["short_bn"](p["short"](pre))
            y = torch.relu(p["bn2"](p["conv1"](pre)))
            return p["conv2"](y) + short
        y = torch.relu(p["bn1"](p["conv1"](xp)))
        y = p["bn2"](p["conv2"](y))
        short = p["short_bn"](p["short"](xp))
        return torch.relu(y + short)

    @staticmethod
    def _up(p: dict, d: torch.Tensor) -> torch.Tensor:
        """dec1 ([B,H/2,W/2,64] -> packed full-res [*,128]) or dec2
        ([B,H/4,W/4,128] -> packed /2 [*,256])."""
        y = p["up"](d)
        for conv, bn in p["convs"]:
            y = torch.relu(bn(conv(y)))
        return y

    def _middle_packed(self, x2):
        """middle (enc2 -> inner -> dec2 + skip) with the /2 stages packed."""
        x2p = s2d(x2)
        d3 = _nchw(self.model.ie_net.inner, self._down(self.enc2, x2p))
        return d2s(self._up(self.dec2, d3) + x2p)

    def _fam_packed(self, xp, fw: _PackedFam, fold: TailG1Packed | None = None):
        """EnhancedFAM on a packed [*, 128] input >= 0. `fold`: the tower's
        packed fusion slice [128, Co] (``pack_tail_g1``), applied to the FAM
        output inside K6;
        None at shapes whose fusion does not refold (1080-row frames), where
        K11 applies the attention without it."""
        out = fam_conv_fused(xp.contiguous(), fw.ka, fw.kb, fw.k1, fw.b1, fw.k32, fw.k42, fw.bias_total, fw.conv)

        # Channel attention: the true per-channel GAP is the mean over packed
        # space AND quadrants.
        b, c4 = out.shape[0], out.shape[-1]
        gap = bf16.mean(bf16.mean(out, (1, 2)).reshape(b, 4, c4 // 4), 1)
        hidden = torch.relu(bf16.add_bias(bf16.matmul(gap, fw.ca_w1), fw.ca_b1))
        ca = bf16.sigmoid(bf16.add_bias(bf16.matmul(hidden, fw.ca_w2), fw.ca_b2))
        # [b, 128], quadrant-tiled; f32, as the JAX kernels take it (exact).
        ca_vec = ca.repeat(1, 4).float().contiguous()

        # Spatial attention per original pixel: per-quadrant channel mean/max,
        # a packed 8-channel map through the packed SA conv.
        sa = bf16.sigmoid(fw.sa(fam_tail_stats(out, ca_vec))).contiguous()
        if fold is None:
            return fam_tail_apply(out, ca_vec, sa)
        return fam_tail_apply_g1(out, ca_vec, sa, fold.w, fold)

    # ---------- full forward ----------

    def __call__(self, x: torch.Tensor):
        """x: [B,H,W,3] float -> (enhanced, reflectance, illumination), NHWC."""
        model = self.model
        if x.shape[1] % 2 or x.shape[2] % 2:  # odd dims: the standard forward
            return model(x)
        xp = s2d(x).to(self.dtype)  # the compute dtype, as the JAX package's

        # IENet: the full-res head and tail packed, the /2 stages packed when
        # they halve evenly, the rest through the standard modules.
        x1p = torch.relu(self.input(xp))
        x2 = self._down(self.enc1, x1p)
        if x2.shape[1] % 2 == 0 and x2.shape[2] % 2 == 0:
            d2 = self._middle_packed(x2)
        else:
            d2 = _nchw(model.ie_net.middle, x2)
        if self.cfg.dec1_chain:
            r = dec1_chain(d2.contiguous(), x1p.contiguous(), *self.dec1_fused, self.dec1_packed)
        else:
            d1p = self._up(self.dec1, d2) + x1p
            r = torch.relu(self.rescv(d1p))
        res_p = self.resout(r)  # [*, 4]
        mean_p = bf16.mean(xp.reshape(*xp.shape[:-1], 4, 3), -1)  # [*, 4]
        illu = d2s(bf16.sigmoid(mean_p + res_p))  # packed 1-channel -> [B,H,W,1]

        reflectance = x / (illu + model.epsilon)

        h, w = x.shape[1], x.shape[2]
        x2s = resize_scale(x, 0.5)
        x3s = resize_scale(x, 0.25)
        h2, w2 = x2s.shape[1], x2s.shape[2]
        # Whether the fusion folds over the low-res towers (shapes refold
        # exactly): the towers pool by 2 and 4 with floor windows. It needs
        # h and w to be multiples of 16, so the packed scale-2 tower below
        # always runs where the fusion folds.
        fold_ok = (
            4 * (h2 // 2) == h
            and 4 * (w2 // 2) == w
            and 16 * (x3s.shape[1] // 4) == h
            and 16 * (x3s.shape[2] // 4) == w
        )

        f1p = torch.relu(self.s1conv(xp))
        g1 = self._fam_packed(f1p, self.fam1, self.fold_f1 if fold_ok else None)
        # scale2 = pool-2 -> 32ch conv -> FAM, packed: the 2x2/s2 max pool in
        # packed space is a per-quadrant channel max.
        use_packed_s2 = 2 * h2 == h and 2 * w2 == w and h2 % 4 == 0 and w2 % 4 == 0
        if use_packed_s2:
            x2p = s2d(x2s.to(self.dtype))  # [B, h2/2, w2/2, 12]
            pooled = x2p.reshape(*x2p.shape[:3], 4, 3).amax(dim=3)
            f2p = torch.relu(self.s2conv(s2d(pooled)))
            f2p = self._fam_packed(f2p, self.fam2, self.fold_f2 if fold_ok else None)
            f2_h, f2_w = 2 * f2p.shape[1], 2 * f2p.shape[2]
        else:
            f2 = _nchw(model.scale2, x2s)
            f2_h, f2_w = f2.shape[1], f2.shape[2]
        f3 = _nchw(model.scale3, x3s)

        assert fold_ok == (4 * f2_h == h and 4 * f2_w == w and 16 * f3.shape[1] == h and 16 * f3.shape[2] == w)
        if fold_ok:
            g2 = d2s(f2p)  # the fusion slice is folded into K6
            g3 = bf16.matmul(f3, self.w_fusion_f3)
            fused = g1 + s2d_upsample_mxu(g2, 4) + s2d_upsample_mxu(g3, 16) + self.b_fusion
        else:  # shapes that do not refold exactly: the direct (resize) form
            if use_packed_s2:
                f2 = d2s(f2p)
            f2p = s2d(resize_bilinear(f2, h, w))
            f3p = s2d(resize_bilinear(f3, h, w))
            fused = self.fusion(_interleave_packed([g1, f2p, f3p], 32))
        e_map = d2s(bf16.sigmoid(self.output(fused)))

        enhanced = reflectance * e_map + (1.0 - reflectance) * (e_map * e_map)
        return enhanced, reflectance, illu
