"""Carry weights into the port: Flax variables -> PyTorch state_dict.

The inverse of ``retinex_tpu/models/convert.py::torch_state_dict_to_variables``.
It takes the JAX package's ``{'params': ..., 'batch_stats': ...}`` as numpy
arrays and returns a state_dict keyed by the reference PyTorch names, which
``MultiScaleUPRetinex.load_state_dict`` takes as it is.

Layouts:
- Conv kernel HWIO [kh,kw,I,O]            -> Conv2d weight [O,I,kh,kw]
- ConvTranspose kernel HWIO, flipped       -> ConvTranspose2d weight [I,O,kh,kw]
  (Flax correlates the kernel over the dilated input, PyTorch computes the
  conv gradient: a spatial flip apart)
- BatchNorm scale/bias + mean/var          -> weight/bias + running_mean/var
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _convT(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resblock(sd, prefix, p, s):
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _bn(sd, f"{prefix}.bn1", p["bn1"], s["bn1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    _bn(sd, f"{prefix}.bn2", p["bn2"], s["bn2"])
    if "shortcut_conv" in p:
        _conv(sd, f"{prefix}.shortcut.0", p["shortcut_conv"])
        _bn(sd, f"{prefix}.shortcut.1", p["shortcut_bn"], s["shortcut_bn"])


def _conv_bn_relu(sd, conv_name, bn_name, p, s):
    _conv(sd, conv_name, p["Conv_0"])
    _bn(sd, bn_name, p["BatchNorm_0"], s["BatchNorm_0"])


def _upblock(sd, prefix, p, s):
    _convT(sd, f"{prefix}.up", p["up"])
    for ours, conv_i, bn_i in (("conv1", 0, 1), ("conv2", 3, 4)):
        _conv_bn_relu(sd, f"{prefix}.conv.{conv_i}", f"{prefix}.conv.{bn_i}", p[ours], s[ours])


def _aspp(sd, prefix, p, s):
    for ours, conv_name, bn_name in [
        ("conv1x1", "conv1x1.0", "conv1x1.1"),
        ("aspp_branch0", "aspp_branches.0.0", "aspp_branches.0.1"),
        ("aspp_branch1", "aspp_branches.1.0", "aspp_branches.1.1"),
        ("aspp_branch2", "aspp_branches.2.0", "aspp_branches.2.1"),
        ("global_pool_conv", "global_pool.1", "global_pool.2"),
        ("fusion", "fusion.0", "fusion.1"),
    ]:
        _conv_bn_relu(sd, f"{prefix}.{conv_name}", f"{prefix}.{bn_name}", p[ours], s[ours])


_FAM = [
    ("branch1", "branch1"),
    ("branch2_conv", "branch2_conv"),
    ("branch3_conv1", "branch3_conv1"),
    ("branch3_conv2", "branch3_conv2"),
    ("branch4_conv1", "branch4_conv1"),
    ("branch4_conv2", "branch4_conv2"),
    ("fusion", "fusion"),
    ("ca_reduce", "channel_attention.1"),
    ("ca_expand", "channel_attention.3"),
    ("sa_conv", "spatial_attention.0"),
]


def variables_to_state_dict(variables, use_preact: bool, use_aspp: bool) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` of MultiScaleUPRetinex (numpy or any
    array convertible with ``np.asarray``) -> the port's state_dict."""
    del use_preact  # both block types share one parameter layout
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    ie_p, ie_s = params["ie_net"], stats["ie_net"]
    _conv(sd, "ie_net.input_layer", ie_p["input_layer"])
    for name in ("enc1", "enc2", "enc3"):
        _resblock(sd, f"ie_net.{name}", ie_p[name], ie_s[name])
    second = "ie_net.bottleneck.2" if use_aspp else "ie_net.bottleneck.1"
    _resblock(sd, "ie_net.bottleneck.0", ie_p["bottleneck1"], ie_s["bottleneck1"])
    if use_aspp:
        _aspp(sd, "ie_net.bottleneck.1", ie_p["aspp"], ie_s["aspp"])
    _resblock(sd, second, ie_p["bottleneck2"], ie_s["bottleneck2"])
    for name in ("dec3", "dec2", "dec1"):
        _upblock(sd, f"ie_net.{name}", ie_p[name], ie_s[name])
    _conv(sd, "ie_net.residual_head.0", ie_p["residual_conv"])
    _conv(sd, "ie_net.residual_head.2", ie_p["residual_out"])

    for ours, conv_name, fam_prefix in [
        ("scale1", "scale1.0", "scale1.2"),
        ("scale2", "scale2.1", "scale2.3"),
        ("scale3", "scale3.1", "scale3.3"),
    ]:
        _conv(sd, conv_name, params[ours]["conv"])
        for fam_ours, theirs in _FAM:
            _conv(sd, f"{fam_prefix}.{theirs}", params[ours]["fam"][fam_ours])

    _conv(sd, "fusion", params["fusion"])
    _conv(sd, "output_layer", params["output_layer"])
    return sd


def load_reference_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """Load a reference ``.pth`` checkpoint ({'epoch', 'model_state_dict', ...}
    or a bare state_dict) -> (state_dict, epoch or -1)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in ckpt:
        return ckpt["model_state_dict"], int(ckpt.get("epoch", -1))
    return ckpt, -1
