"""Convolutions, products and means in a reduced compute dtype (bf16),
rounded where the JAX package rounds them.

The JAX package computes its ``--use_amp`` net in ``model.dtype``
(``jnp.bfloat16``) with f32 parameters. Flax's ``nn.Conv(dtype=bf16)`` and
``lax.conv_general_dilated`` on bf16 operands round the kernel to bf16, sum
the exact bf16 x bf16 products in f32, round the sum to bf16 once, and then
add the bias rounded to bf16, a second rounding (XLA's CPU backend does
exactly this; ``tests/test_torch_amp_net.py`` holds each layer to Flax).
``jnp.mean`` of a bf16 array sums and divides in f32 and rounds once.
``jax.nn.sigmoid`` of a bf16 array is XLA's expansion 1 / (1 + exp(-x)),
each of its three operations rounded to bf16.

Each function here takes its activation in the compute dtype and returns
the result in it. f32 goes straight to the PyTorch op. bf16 runs on the CPU
as f32 arithmetic on the bf16 values, rounded at the same points (PyTorch's
own CPU bf16 convolution accumulates in another order); on the card it
runs PyTorch's bf16 op, which sums in f32 and rounds once (cuDNN, and
cuBLAS with ``allow_bf16_reduced_precision_reduction`` off, which the CLI
sets).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32_on_cpu(x: torch.Tensor) -> bool:
    """bf16 arithmetic emulated in f32: a reduced dtype on the CPU."""
    return x.dtype != torch.float32 and x.device.type == "cpu"


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, dilation=1) -> torch.Tensor:
    """NCHW x in its dtype, the OIHW `weight` rounded to it, no bias: the
    f32 sum of the products, rounded to x.dtype once."""
    w = weight.to(x.dtype)
    if _f32_on_cpu(x):
        return F.conv2d(x.float(), w.float(), None, stride, padding, dilation).to(x.dtype)
    return F.conv2d(x, w, None, stride, padding, dilation)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, stride=1) -> torch.Tensor:
    """``F.conv_transpose2d`` of NCHW x with the weight rounded to x.dtype,
    no bias, rounded to x.dtype once."""
    w = weight.to(x.dtype)
    if _f32_on_cpu(x):
        return F.conv_transpose2d(x.float(), w.float(), None, stride).to(x.dtype)
    return F.conv_transpose2d(x, w, None, stride)


def add_bias(y: torch.Tensor, bias: torch.Tensor | None, nchw: bool = False) -> torch.Tensor:
    """y + bias rounded to y.dtype, in y.dtype (Flax's ``y += bias``); the
    channels last, or second where `nchw`."""
    if bias is None:
        return y
    b = bias.to(y.dtype)
    return y + (b[:, None, None] if nchw else b)


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with w rounded to a.dtype: the f32 sum rounded once."""
    wr = w.to(a.dtype)
    if _f32_on_cpu(a):
        return (a.float() @ wr.float()).to(a.dtype)
    return a @ wr


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``torch.einsum(spec, a, b)`` of two operands in `dtype` (an f32
    operand is rounded to it): the f32 sum rounded to `dtype` once."""
    a, b = a.to(dtype), b.to(dtype)
    if dtype != torch.float32 and a.device.type == "cpu":
        return torch.einsum(spec, a.float(), b.float()).to(dtype)
    return torch.einsum(spec, a, b)


def mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: a bf16 x summed and divided in f32, rounded once."""
    if x.dtype == torch.float32:
        return x.mean(dim=dim, keepdim=keepdim)
    return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: f32 ``torch.sigmoid``; in a reduced dtype XLA's
    1 / (1 + exp(-x)), each operation rounded to x.dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))
