"""Plain reference of the default enhance route: the net's standard
forward in f32, then Lab-CLAHE (clip 2.0, 8 x 8 tiles) on its clamped
output. Runs in blocks of frames on the given device."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import clahe, net, precision


def enhance(sd: dict, frames_u8: list[np.ndarray], use_preact: bool, use_aspp: bool, device,
            lower: bool = False, block: int = 4) -> list[tuple[np.ndarray, np.ndarray]]:
    """uint8 HWC frames of one size -> [(enhanced uint8 HWC, illumination
    f32 HW1)] per frame. `lower`: the control, every convolution's
    operands rounded to TF32 (``reference/precision.py``)."""
    with precision.tf32(torch.device(device)) if lower else contextlib.nullcontext((None, None)) as (conv, conv_t):
        return _enhance(sd, frames_u8, use_preact, use_aspp, device, conv, conv_t, block)


def _enhance(sd, frames_u8, use_preact, use_aspp, device, conv, conv_t, block):
    out = []
    for i in range(0, len(frames_u8), block):
        x = torch.from_numpy(np.stack(frames_u8[i : i + block])).to(device).float() / 255.0
        enh, illu = net.forward(sd, x, use_preact, use_aspp, conv=conv, conv_t=conv_t)
        enh_u8 = clahe.lab_clahe(enh)
        for j in range(x.shape[0]):
            out.append((enh_u8[j].cpu().numpy(), illu[j].cpu().numpy()))
        del x, enh, illu, enh_u8
    return out
