"""The control's precision: TF32, the step below the configurations' f32
with TF32 off.

On the card the reference runs with cuDNN's and cuBLAS's TF32 switched on:
the tensor cores round every convolution's operands to TF32 (10 mantissa
bits), forward and backward, and sum in f32. On the CPU, which has no TF32,
``tf32`` gives convolutions that round their operands the same way, to
nearest, in the forward and in both products of the backward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, b is not None)
        return F.conv2d(to_tf32(x), to_tf32(w), b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, has_b = ctx.conf
        g32 = to_tf32(g)
        gx = torch.nn.grad.conv2d_input(x.shape, to_tf32(w), g32, stride, padding, dilation)
        gw = torch.nn.grad.conv2d_weight(to_tf32(x), w.shape, g32, stride, padding, dilation)
        gb = g.sum(dim=(0, 2, 3)) if has_b else None
        return gx, gw, gb, None, None, None


def tf32_conv(x, w, b, stride, padding, dilation):
    return _Conv.apply(x, w, b, stride, padding, dilation)


def tf32_conv_t(x, w, b):
    """The k2 s2 transposed convolution with TF32 operands (its gradient
    taken through the rounding as it stands)."""
    xr = x + (to_tf32(x) - x).detach()
    wr = w + (to_tf32(w) - w).detach()
    return F.conv_transpose2d(xr, wr, b, stride=2)


@contextlib.contextmanager
def tf32(device: torch.device):
    """Yields (conv, conv_t) for the reference's layers: on the card None,
    None with TF32 switched on for the block; on the CPU the rounding
    convolutions above."""
    if device.type != "cuda":
        yield tf32_conv, tf32_conv_t
        return
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield None, None
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
