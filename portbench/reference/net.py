"""Plain PyTorch reference of MultiScaleUPRetinex (the UP-Retinex net of
xh92117/Retinex-image-Enhancement, ``models/model.py``), frozen for the
benchmark.

Functional: every layer reads its tensors from a state dict keyed as the
reference repository's checkpoints are (``ie_net.enc1.conv1.weight``, ...).
NCHW inside, f32, no kernels, no packing, no batching tricks. ``spec``
lists every tensor with its shape and kind, so the benchmark can draw
weights without the program. ``conv`` is the convolution every layer calls:
``F.conv2d`` for the reference, a lower-precision one for the control.

Eval mode runs BatchNorm on the running statistics. Train mode follows the
JAX package's semantics (Flax's BatchNorm): the biased batch variance
``max(0, E[x^2] - E[x]^2)`` over N, H, W, and running statistics
``0.9 * running + 0.1 * batch``, returned in ``stats``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FAM_WIDTH = 32


def _conv_spec(spec, name, cin, cout, k, bias=True, transpose=False):
    spec[f"{name}.weight"] = ((cin, cout, k, k) if transpose else (cout, cin, k, k), "convT" if transpose else "conv")
    if bias:
        spec[f"{name}.bias"] = ((cout,), "bias")


def _bn_spec(spec, name, ch):
    for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        spec[f"{name}.{leaf}"] = ((ch,), kind)
    spec[f"{name}.num_batches_tracked"] = ((), "count")


def _block_spec(spec, name, cin, cout, stride, preact):
    _bn_spec(spec, f"{name}.bn1", cin if preact else cout)
    _conv_spec(spec, f"{name}.conv1", cin, cout, 3, bias=False)
    _bn_spec(spec, f"{name}.bn2", cout)
    _conv_spec(spec, f"{name}.conv2", cout, cout, 3, bias=False)
    if stride != 1 or cin != cout:
        _conv_spec(spec, f"{name}.shortcut.0", cin, cout, 1, bias=False)
        _bn_spec(spec, f"{name}.shortcut.1", cout)


def _cbr_spec(spec, conv_name, bn_name, cin, cout, k, bias=False):
    _conv_spec(spec, conv_name, cin, cout, k, bias=bias)
    _bn_spec(spec, bn_name, cout)


def _fam_spec(spec, name, f=FAM_WIDTH):
    for br, k in (("branch1", 1), ("branch2_conv", 1), ("branch3_conv1", 3), ("branch3_conv2", 3),
                  ("branch4_conv1", 3), ("branch4_conv2", 3)):
        _conv_spec(spec, f"{name}.{br}", f, f, k)
    _conv_spec(spec, f"{name}.fusion", 4 * f, f, 1)
    _conv_spec(spec, f"{name}.channel_attention.1", f, f // 16, 1)
    _conv_spec(spec, f"{name}.channel_attention.3", f // 16, f, 1)
    _conv_spec(spec, f"{name}.spatial_attention.0", 2, 1, 7)


def spec(use_preact: bool, use_aspp: bool) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, kind) of every tensor of the net's state dict, in the
    reference layout: conv weights [O, I, k, k], transposed conv weights
    [I, O, k, k]."""
    s: dict = {}
    _conv_spec(s, "ie_net.input_layer", 3, 32, 3)
    for name, cin, cout in (("enc1", 32, 64), ("enc2", 64, 128), ("enc3", 128, 256)):
        _block_spec(s, f"ie_net.{name}", cin, cout, 2, use_preact)
    _block_spec(s, "ie_net.bottleneck.0", 256, 256, 1, use_preact)
    if use_aspp:
        a = "ie_net.bottleneck.1"
        _cbr_spec(s, f"{a}.conv1x1.0", f"{a}.conv1x1.1", 256, 256, 1)
        for i in range(3):
            _cbr_spec(s, f"{a}.aspp_branches.{i}.0", f"{a}.aspp_branches.{i}.1", 256, 256, 3)
        _cbr_spec(s, f"{a}.global_pool.1", f"{a}.global_pool.2", 256, 256, 1)
        _cbr_spec(s, f"{a}.fusion.0", f"{a}.fusion.1", 5 * 256, 256, 1)
    _block_spec(s, "ie_net.bottleneck.2" if use_aspp else "ie_net.bottleneck.1", 256, 256, 1, use_preact)
    for name, cin, cout in (("dec3", 256, 128), ("dec2", 128, 64), ("dec1", 64, 32)):
        _conv_spec(s, f"ie_net.{name}.up", cin, cout, 2, transpose=True)
        _cbr_spec(s, f"ie_net.{name}.conv.0", f"ie_net.{name}.conv.1", cout, cout, 3, bias=True)
        _cbr_spec(s, f"ie_net.{name}.conv.3", f"ie_net.{name}.conv.4", cout, cout, 3, bias=True)
    _conv_spec(s, "ie_net.residual_head.0", 32, 32, 3)
    _conv_spec(s, "ie_net.residual_head.2", 32, 1, 1)
    for tower, conv_i, fam_i in (("scale1", 0, 2), ("scale2", 1, 3), ("scale3", 1, 3)):
        _conv_spec(s, f"{tower}.{conv_i}", 3, FAM_WIDTH, 3)
        _fam_spec(s, f"{tower}.{fam_i}")
    _conv_spec(s, "fusion", 3 * FAM_WIDTH, FAM_WIDTH, 1)
    _conv_spec(s, "output_layer", FAM_WIDTH, 3, 1)
    return s


def _dilation_of(name: str) -> int:
    if ".aspp_branches." in name:
        return (6, 12, 18)[int(name.split(".aspp_branches.")[1].split(".")[0])]
    if name.endswith("branch4_conv2"):
        return 2
    return 1


class Net:
    """One forward of the reference net over state dict `sd`.

    `train`: BatchNorm on batch statistics (new running statistics land in
    ``self.stats``); `conv`: the convolution (x, w, b, stride, padding,
    dilation) -> y; `conv_t`: the transposed convolution (x, w, b) -> y."""

    def __init__(self, sd, use_preact, use_aspp, train=False, conv=None, conv_t=None, dropout=None):
        self.sd = sd
        self.use_preact = use_preact
        self.use_aspp = use_aspp
        self.train = train
        self.conv_fn = conv or F.conv2d
        self.conv_t_fn = conv_t or (lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2))
        self.dropout = dropout  # x -> x, the ASPP's train-mode dropout
        self.stats: dict[str, torch.Tensor] = {}

    def conv(self, name, x, stride=1):
        w = self.sd[f"{name}.weight"]
        d = _dilation_of(name)
        return self.conv_fn(x, w, self.sd.get(f"{name}.bias"), stride, d * (w.shape[-1] // 2), d)

    def bn(self, name, x):
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.stats[f"{name}.running_mean"] = 0.9 * self.sd[f"{name}.running_mean"] + 0.1 * mean
                self.stats[f"{name}.running_var"] = 0.9 * self.sd[f"{name}.running_var"] + 0.1 * var
        else:
            mean, var = self.sd[f"{name}.running_mean"], self.sd[f"{name}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * w
        return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]

    def block(self, name, x, stride=1):
        has_short = f"{name}.shortcut.0.weight" in self.sd
        if self.use_preact:
            pre = F.relu(self.bn(f"{name}.bn1", x))
            sc = self.bn(f"{name}.shortcut.1", self.conv(f"{name}.shortcut.0", pre, stride)) if has_short else x
            y = F.relu(self.bn(f"{name}.bn2", self.conv(f"{name}.conv1", pre, stride)))
            return self.conv(f"{name}.conv2", y) + sc
        y = F.relu(self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x, stride)))
        y = self.bn(f"{name}.bn2", self.conv(f"{name}.conv2", y))
        sc = self.bn(f"{name}.shortcut.1", self.conv(f"{name}.shortcut.0", x, stride)) if has_short else x
        return F.relu(y + sc)

    def cbr(self, conv_name, bn_name, x):
        return F.relu(self.bn(bn_name, self.conv(conv_name, x)))

    def aspp(self, name, x):
        h, w = x.shape[2], x.shape[3]
        feats = [self.cbr(f"{name}.conv1x1.0", f"{name}.conv1x1.1", x)]
        feats += [self.cbr(f"{name}.aspp_branches.{i}.0", f"{name}.aspp_branches.{i}.1", x) for i in range(3)]
        g = self.cbr(f"{name}.global_pool.1", f"{name}.global_pool.2", x.mean(dim=(2, 3), keepdim=True))
        feats.append(g.expand(-1, -1, h, w))
        y = self.cbr(f"{name}.fusion.0", f"{name}.fusion.1", torch.cat(feats, dim=1))
        return self.dropout(y) if (self.train and self.dropout is not None) else y

    def up(self, name, x):
        y = self.conv_t_fn(x, self.sd[f"{name}.up.weight"], self.sd[f"{name}.up.bias"])
        y = self.cbr(f"{name}.conv.0", f"{name}.conv.1", y)
        return self.cbr(f"{name}.conv.3", f"{name}.conv.4", y)

    def ie_net(self, x):
        x1 = F.relu(self.conv("ie_net.input_layer", x))
        x2 = self.block("ie_net.enc1", x1, 2)
        x3 = self.block("ie_net.enc2", x2, 2)
        y = self.block("ie_net.enc3", x3, 2)
        y = self.block("ie_net.bottleneck.0", y)
        if self.use_aspp:
            y = self.aspp("ie_net.bottleneck.1", y)
        y = self.block("ie_net.bottleneck.2" if self.use_aspp else "ie_net.bottleneck.1", y)
        d3 = self.up("ie_net.dec3", y) + x3
        d2 = self.up("ie_net.dec2", d3) + x2
        d1 = self.up("ie_net.dec1", d2) + x1
        r = self.conv("ie_net.residual_head.2", F.relu(self.conv("ie_net.residual_head.0", d1)))
        return torch.sigmoid(x.mean(dim=1, keepdim=True) + r)

    def fam(self, name, x):
        b1 = self.conv(f"{name}.branch1", x)
        b2 = self.conv(f"{name}.branch2_conv", F.max_pool2d(x, 3, 1, 1))
        b3 = self.conv(f"{name}.branch3_conv2", F.relu(self.conv(f"{name}.branch3_conv1", x)))
        b4 = self.conv(f"{name}.branch4_conv2", F.relu(self.conv(f"{name}.branch4_conv1", x)))
        out = F.relu(self.conv(f"{name}.fusion", torch.cat([b1, b2, b3, b4], dim=1)))
        hid = F.relu(self.conv(f"{name}.channel_attention.1", out.mean(dim=(2, 3), keepdim=True)))
        out = out * torch.sigmoid(self.conv(f"{name}.channel_attention.3", hid))
        sa_in = torch.cat([out.mean(dim=1, keepdim=True), out.amax(dim=1, keepdim=True)], dim=1)
        return out * torch.sigmoid(self.conv(f"{name}.spatial_attention.0", sa_in))

    def tower(self, name, x, pool):
        if pool > 1:
            x = F.max_pool2d(x, pool)
        conv_i, fam_i = (0, 2) if pool == 1 else (1, 3)
        return self.fam(f"{name}.{fam_i}", F.relu(self.conv(f"{name}.{conv_i}", x)))

    def __call__(self, x):
        """x: [B, 3, H, W] in [0, 1] -> (enhanced, reflectance, illumination), NCHW."""
        illu = self.ie_net(x)
        refl = x / (illu + 1e-6)
        h, w = x.shape[2], x.shape[3]
        x2 = resize(x, int(h * 0.5), int(w * 0.5))
        x3 = resize(x, int(h * 0.25), int(w * 0.25))
        f1 = self.tower("scale1", x, 1)
        f2 = resize(self.tower("scale2", x2, 2), h, w)
        f3 = resize(self.tower("scale3", x3, 4), h, w)
        e = torch.sigmoid(self.conv("output_layer", self.conv("fusion", torch.cat([f1, f2, f3], dim=1))))
        return refl * e + (1.0 - refl) * (e * e), refl, illu


def resize(x, h, w):
    """Bilinear, half-pixel centres, no antialiasing (cv2's INTER_LINEAR)."""
    if (x.shape[2], x.shape[3]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)


def forward(sd, x_nhwc, use_preact, use_aspp, conv=None, conv_t=None):
    """Eval-mode forward of NHWC images -> (enhanced, illumination), NHWC."""
    with torch.no_grad():
        enhanced, _refl, illu = Net(sd, use_preact, use_aspp, conv=conv, conv_t=conv_t)(x_nhwc.permute(0, 3, 1, 2))
    return enhanced.permute(0, 2, 3, 1), illu.permute(0, 2, 3, 1)
