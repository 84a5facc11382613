"""Model FLOPs of the net and of the training step, counted from the
reference modules' shapes.

Each function runs the plain reference (``reference/``) on meta tensors
under ``torch.utils.flop_counter.FlopCounterMode``: 2 x the multiply-adds
of every convolution and transposed convolution (and, in training, of
their backward and the decoupling loss's batched product), as the standard
forward computes them, whatever a program computes in their place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.common import weights
from portbench.reference import net as rnet
from portbench.reference import train as rtrain

TRAINABLE = ("conv", "convT", "bias", "bn_w", "bn_b")


def _meta(spec: dict, grad: bool = False) -> dict:
    return {k: torch.empty(s, device="meta", requires_grad=grad and kind in TRAINABLE) for k, (s, kind) in spec.items()}


@functools.lru_cache(maxsize=None)
def net_forward(use_preact: bool, use_aspp: bool, h: int, w: int) -> int:
    """FLOPs of the standard forward of one h x w image."""
    sd = _meta(rnet.spec(use_preact, use_aspp))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        rnet.Net(sd, use_preact, use_aspp)(torch.empty(1, 3, h, w, device="meta"))
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def train_step(use_preact: bool, use_aspp: bool, batch: int, size: int) -> int:
    """FLOPs of one training step on a [batch, size, size, 3] batch: the
    net's train-mode forward, the losses with VGG19 to pool3 on the enhanced
    image and the input, and the gradients of the net's parameters."""
    spec = rnet.spec(use_preact, use_aspp)
    sd = _meta(spec, grad=True)
    vgg = _meta(weights.vgg_spec())
    x = torch.empty(batch, size, size, 3, device="meta")
    params = [v for k, v in sd.items() if spec[k][1] in TRAINABLE]
    with FlopCounterMode(display=False) as counter:
        net = rnet.Net(sd, use_preact, use_aspp, train=True)
        enh, refl, illu = (t.permute(0, 2, 3, 1) for t in net(x.permute(0, 3, 1, 2)))
        total = sum(rtrain.losses(x, enh, illu, refl, vgg, F.conv2d).values())
        torch.autograd.grad(total, params)
    return counter.get_total_flops()
