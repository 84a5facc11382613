"""Carry weights and train state between the JAX package and the port.

``variables_to_state_dict`` is the inverse of
``retinex_tpu/models/convert.py::torch_state_dict_to_variables``: it takes
the JAX package's ``{'params': ..., 'batch_stats': ...}`` as numpy arrays and
returns a state_dict keyed by the reference PyTorch names, which
``MultiScaleUPRetinex.load_state_dict`` takes as it is. ``state_dict_to_variables``
is the reverse (port -> Flax names); it takes any dict keyed by the port's
names (parameters, their gradients, Adam's moments), so a test can compare
a whole pytree leaf by leaf. ``vgg_variables_to_state_dict`` carries the
perceptual loss's VGG19, and ``adam_state_to_port`` / ``adam_state_to_optax``
optax's ``ScaleByAdamState`` (``mu``, ``nu``, ``count``).

Layouts:
- Conv kernel HWIO [kh,kw,I,O]            <-> Conv2d weight [O,I,kh,kw]
- ConvTranspose kernel HWIO, flipped       <-> ConvTranspose2d weight [I,O,kh,kw]
  (Flax correlates the kernel over the dilated input, PyTorch computes the
  conv gradient: a spatial flip apart)
- BatchNorm scale/bias + mean/var          <-> weight/bias + running_mean/var
"""

from __future__ import annotations

import numpy as np
import torch

# Entry kinds: how a Flax leaf maps onto a torch tensor.
CONV, CONVT, VEC = "conv", "convT", "vec"


def _conv(table, name, path, bias=True):
    table.append((f"{name}.weight", ("params", *path, "kernel"), CONV))
    if bias:
        table.append((f"{name}.bias", ("params", *path, "bias"), VEC))


def _bn(table, name, path):
    for ours, theirs in (("weight", "scale"), ("bias", "bias")):
        table.append((f"{name}.{ours}", ("params", *path, theirs), VEC))
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        table.append((f"{name}.{ours}", ("batch_stats", *path, theirs), VEC))


def _resblock(table, prefix, path):
    _conv(table, f"{prefix}.conv1", (*path, "conv1"), bias=False)
    _bn(table, f"{prefix}.bn1", (*path, "bn1"))
    _conv(table, f"{prefix}.conv2", (*path, "conv2"), bias=False)
    _bn(table, f"{prefix}.bn2", (*path, "bn2"))
    _conv(table, f"{prefix}.shortcut.0", (*path, "shortcut_conv"), bias=False)
    _bn(table, f"{prefix}.shortcut.1", (*path, "shortcut_bn"))


def _conv_bn_relu(table, conv_name, bn_name, path, bias=False):
    _conv(table, conv_name, (*path, "Conv_0"), bias=bias)
    _bn(table, bn_name, (*path, "BatchNorm_0"))


def _upblock(table, prefix, path):
    table.append((f"{prefix}.up.weight", ("params", *path, "up", "kernel"), CONVT))
    table.append((f"{prefix}.up.bias", ("params", *path, "up", "bias"), VEC))
    for ours, conv_i, bn_i in (("conv1", 0, 1), ("conv2", 3, 4)):
        _conv_bn_relu(table, f"{prefix}.conv.{conv_i}", f"{prefix}.conv.{bn_i}", (*path, ours), bias=True)


_ASPP = [
    ("conv1x1", "conv1x1.0", "conv1x1.1"),
    ("aspp_branch0", "aspp_branches.0.0", "aspp_branches.0.1"),
    ("aspp_branch1", "aspp_branches.1.0", "aspp_branches.1.1"),
    ("aspp_branch2", "aspp_branches.2.0", "aspp_branches.2.1"),
    ("global_pool_conv", "global_pool.1", "global_pool.2"),
    ("fusion", "fusion.0", "fusion.1"),
]

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


def param_table(use_aspp: bool) -> list[tuple[str, tuple[str, ...], str]]:
    """(torch name, Flax path from the collection, kind) of every tensor
    MultiScaleUPRetinex may hold; the projection shortcuts appear whether
    a block has one or not (each direction skips what its input lacks)."""
    table: list = []
    ie = ("ie_net",)
    _conv(table, "ie_net.input_layer", (*ie, "input_layer"))
    for name in ("enc1", "enc2", "enc3"):
        _resblock(table, f"ie_net.{name}", (*ie, name))
    _resblock(table, "ie_net.bottleneck.0", (*ie, "bottleneck1"))
    if use_aspp:
        for ours, conv_name, bn_name in _ASPP:
            _conv_bn_relu(table, f"ie_net.bottleneck.1.{conv_name}", f"ie_net.bottleneck.1.{bn_name}", (*ie, "aspp", ours))
    _resblock(table, "ie_net.bottleneck.2" if use_aspp else "ie_net.bottleneck.1", (*ie, "bottleneck2"))
    for name in ("dec3", "dec2", "dec1"):
        _upblock(table, f"ie_net.{name}", (*ie, name))
    _conv(table, "ie_net.residual_head.0", (*ie, "residual_conv"))
    _conv(table, "ie_net.residual_head.2", (*ie, "residual_out"))
    for ours, conv_name, fam_prefix in [
        ("scale1", "scale1.0", "scale1.2"),
        ("scale2", "scale2.1", "scale2.3"),
        ("scale3", "scale3.1", "scale3.3"),
    ]:
        _conv(table, conv_name, (ours, "conv"))
        for fam_ours, theirs in _FAM:
            _conv(table, f"{fam_prefix}.{theirs}", (ours, "fam", fam_ours))
    _conv(table, "fusion", ("fusion",))
    _conv(table, "output_layer", ("output_layer",))
    return table


def _to_torch(a, kind: str) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    if kind == CONV:
        a = a.transpose(3, 2, 0, 1)
    elif kind == CONVT:
        a = a[::-1, ::-1].transpose(2, 3, 0, 1)
    return torch.tensor(np.ascontiguousarray(a))


def _to_flax(t, kind: str) -> np.ndarray:
    a = t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    if kind == CONV:
        a = a.transpose(2, 3, 1, 0)
    elif kind == CONVT:
        a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return np.ascontiguousarray(a)


def _get(tree, path):
    for k in path:
        if k not in tree:
            return None
        tree = tree[k]
    return tree


def variables_to_state_dict(variables, use_preact: bool, use_aspp: bool) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` of MultiScaleUPRetinex (numpy or any
    array convertible with ``np.asarray``) -> the port's state_dict."""
    del use_preact  # both block types share one parameter layout
    sd: dict[str, torch.Tensor] = {}
    for name, path, kind in param_table(use_aspp):
        leaf = _get(variables, path)
        if leaf is not None:
            sd[name] = _to_torch(leaf, kind)
            if name.endswith(".running_var"):
                sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
    return sd


def state_dict_to_variables(sd, use_aspp: bool) -> dict:
    """Any dict keyed by the port's names (a state_dict, the parameters'
    gradients, Adam's moments) -> the Flax pytree of nested dicts of numpy
    arrays, one collection per kind present (``params``, ``batch_stats``)."""
    out: dict = {}
    for name, path, kind in param_table(use_aspp):
        if name in sd:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _to_flax(sd[name], kind)
    return out


def vgg_variables_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """The JAX package's VGG19Features ``{'params': {'conv0': ...}}`` -> the
    port's VGG19Features state_dict (torchvision's ``{i}.weight``)."""
    sd = {}
    for name, p in variables["params"].items():
        i = name.removeprefix("conv")
        sd[f"{i}.weight"] = _to_torch(p["kernel"], CONV)
        sd[f"{i}.bias"] = _to_torch(p["bias"], VEC)
    return sd


def adam_state_to_port(mu, nu, count, use_aspp: bool) -> dict:
    """optax ``ScaleByAdamState`` (``mu`` and ``nu`` as Flax params pytrees,
    ``count``) -> the port's optimizer moments: ``{'mu': {name: tensor},
    'nu': {...}, 'count': int}`` (``train/train_state.Optimizer``)."""
    moments = {}
    for key, tree in (("mu", mu), ("nu", nu)):
        sd = variables_to_state_dict({"params": tree}, False, use_aspp)
        moments[key] = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return {**moments, "count": int(np.asarray(count))}


def adam_state_to_optax(moments: dict, use_aspp: bool) -> tuple[dict, dict, int]:
    """The port's optimizer moments -> (mu, nu, count) as optax's
    ``ScaleByAdamState`` holds them (Flax params pytrees of numpy arrays)."""
    return (
        state_dict_to_variables(moments["mu"], use_aspp)["params"],
        state_dict_to_variables(moments["nu"], use_aspp)["params"],
        int(moments["count"]),
    )


def load_reference_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """Load a reference ``.pth`` checkpoint ({'epoch', 'model_state_dict', ...}
    or a bare state_dict), or one of the port's own (which holds the same
    two keys) -> (state_dict, epoch or -1)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in ckpt:
        return ckpt["model_state_dict"], int(ckpt.get("epoch", -1))
    return ckpt, -1
