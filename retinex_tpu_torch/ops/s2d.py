"""Space-to-depth (2x2) convolution transforms, in PyTorch on NHWC tensors.

Counterpart of ``retinex_tpu/ops/s2d.py``. A narrow-channel convolution is
rewritten exactly as a wide-channel one at half resolution: ``s2d`` packs
pixel (2I+a, 2J+b), channel c into packed channel (a*2 + b)*C + c at packed
position (I, J), and the packers below build the packed kernels so that the
packed outputs equal the original convolution's up to float reassociation.
All transforms assume 'SAME' zero padding and odd kernel sizes; H and W must
be even (the letterbox pads to multiples of 32).

Activations are NHWC and kernels HWIO, as in the JAX package. The packing
tables are numpy float32, built once when a model is packed; the
convolutions themselves run through ``F.conv2d`` on an NCHW view.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from retinex_tpu_torch.ops import bf16


def s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] (quadrant-major channel blocks)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def d2s(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`. [B, h, w, 4C] -> [B, 2h, 2w, C]."""
    b, hh, ww, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, hh, ww, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * hh, 2 * ww, c)


def pack_kernel_s1(kernel, dilation: int = 1) -> np.ndarray:
    """Pack an odd kxk stride-1 HWIO kernel [k,k,Cin,Cout] (torch-parity
    padding r*dilation) into the packed HWIO kernel [kp,kp,4Cin,4Cout].

    Output quadrant (c, d) at packed (I, J) reads original tap (u, v) from
    row 2I + c + u*dilation = 2P + a, i.e. packed tap P, input quadrant a
    (likewise for columns). A dilation-2 kernel folds to dense packed taps."""
    kern = np.asarray(kernel, dtype=np.float32)
    k, cin, cout = kern.shape[0], kern.shape[2], kern.shape[3]
    r = k // 2
    rd = r * dilation
    p_min = int(np.floor(-rd / 2))
    p_max = int(np.floor((rd + 1) / 2))
    kp = p_max - p_min + 1
    out = np.zeros((kp, kp, 4 * cin, 4 * cout), dtype=np.float32)
    for c_q in range(2):
        for d_q in range(2):
            for u in range(-r, r + 1):
                for v in range(-r, r + 1):
                    ue, ve = u * dilation, v * dilation
                    a, p = (c_q + ue) & 1, (c_q + ue) >> 1
                    b_, q = (d_q + ve) & 1, (d_q + ve) >> 1
                    # u -> (P, a) is injective for a fixed c_q: no tap is
                    # written twice.
                    out[
                        p - p_min,
                        q - p_min,
                        (a * 2 + b_) * cin : (a * 2 + b_ + 1) * cin,
                        (c_q * 2 + d_q) * cout : (c_q * 2 + d_q + 1) * cout,
                    ] += kern[u + r, v + r]
    return out


def pack_kernel_s2(kernel) -> np.ndarray:
    """Pack an odd kxk stride-2 HWIO kernel into a packed stride-1 kernel
    [kp,kp,4Cin,Cout] whose output IS the original stride-2 output."""
    kern = np.asarray(kernel, dtype=np.float32)
    k, cin, cout = kern.shape[0], kern.shape[2], kern.shape[3]
    r = k // 2
    p_min = int(np.floor(-r / 2))
    p_max = int(np.floor(r / 2))
    kp = p_max - p_min + 1
    out = np.zeros((kp, kp, 4 * cin, cout), dtype=np.float32)
    for u in range(-r, r + 1):
        for v in range(-r, r + 1):
            a, p = u & 1, u >> 1
            b_, q = v & 1, v >> 1
            out[p - p_min, q - p_min, (a * 2 + b_) * cin : (a * 2 + b_ + 1) * cin, :] += kern[u + r, v + r]
    return out


def pack_pointwise(kernel) -> np.ndarray:
    """Pack a 1x1 HWIO kernel [1,1,Cin,Cout] -> [1,1,4Cin,4Cout]
    (block diagonal over quadrants)."""
    kern = np.asarray(kernel, dtype=np.float32)[0, 0]
    cin, cout = kern.shape
    out = np.zeros((1, 1, 4 * cin, 4 * cout), dtype=np.float32)
    for q in range(4):
        out[0, 0, q * cin : (q + 1) * cin, q * cout : (q + 1) * cout] = kern
    return out


def hwio_to_oihw(kernel) -> torch.Tensor:
    """HWIO kernel (numpy, or a tensor on any device) -> contiguous f32
    OIHW tensor, the layout ``F.conv2d`` takes."""
    k = kernel if isinstance(kernel, torch.Tensor) else torch.tensor(np.asarray(kernel, np.float32))
    return k.float().permute(3, 2, 0, 1).contiguous()


def conv_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    pad: tuple[int, int] = (0, 0),
    dilation: int = 1,
) -> torch.Tensor:
    """Stride-1 convolution of NHWC x with an OIHW weight; `pad` = (low,
    high) zero padding on both spatial axes. The NCHW view handed to
    ``F.conv2d`` is channels-last in memory, so no copy is made and the
    result comes back as a contiguous NHWC tensor. A bf16 x computes as the
    JAX package's ``lax.conv`` in bf16 (``ops/bf16.py``): the weight rounded
    to bf16, the sum rounded once, then the bias added in bf16."""
    xc = x.permute(0, 3, 1, 2)
    lo, hi = pad
    if x.dtype != torch.float32:
        if lo != hi:
            xc, lo = F.pad(xc, (lo, hi, lo, hi)), 0
        return bf16.add_bias(bf16.conv2d(xc, weight, 1, lo, dilation).permute(0, 2, 3, 1), bias)
    if lo == hi:
        out = F.conv2d(xc, weight, bias, padding=lo, dilation=dilation)
    else:
        out = F.conv2d(F.pad(xc, (lo, hi, lo, hi)), weight, bias, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def packed_pad(kp: int) -> tuple[int, int]:
    """Low-heavy padding of a packed kp-tap kernel: its tap range starts at
    -kp//2 for the stride-1 (odd kp) and the stride-2 (even kp) packings."""
    return kp // 2, kp - 1 - kp // 2


def tile_bias(bias: torch.Tensor, cout: int) -> torch.Tensor:
    """The original [C] bias tiled per quadrant to the packed width."""
    return bias.repeat(cout // bias.shape[0])


def conv_s2d(x_packed: torch.Tensor, packed_kernel, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Run a packed HWIO kernel on packed NHWC x (zero padding equivalent to
    the original 'SAME', stride 1 on the packed grid). bias: the original
    [Cout] bias, tiled per quadrant when the kernel emits 4*Cout channels."""
    w = hwio_to_oihw(packed_kernel).to(x_packed.device)
    b = None if bias is None else tile_bias(bias.to(x_packed.device), w.shape[0])
    return conv_nhwc(x_packed, w, b, packed_pad(w.shape[2]))


def maxpool3x3_s1_s2d(x_packed: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool ('SAME', -inf padding) per ORIGINAL pixel, in
    packed space.

    Separable: a 3-tap max along rows, then along columns. Output
    row-quadrant c at packed row I covers original rows 2I+c-1 .. 2I+c+1:
    c=0 -> {(I-1,a=1), (I,a=0), (I,a=1)}, c=1 -> {(I,a=0), (I,a=1),
    (I+1,a=0)}. The column pass is the same in d."""
    b, hh, ww, c4 = x_packed.shape
    c = c4 // 4
    q = x_packed.reshape(b, hh, ww, 2, 2, c)
    neg = torch.full((b, 1, ww, 2, 2, c), float("-inf"), dtype=q.dtype, device=q.device)
    qp = torch.cat([neg, q, neg], dim=1)
    both = torch.maximum(q[:, :, :, 0], q[:, :, :, 1])  # max over a at row I
    v0 = torch.maximum(qp[:, 0:hh, :, 1], both)
    v1 = torch.maximum(both, qp[:, 2 : 2 + hh, :, 0])
    v = torch.stack([v0, v1], dim=3)  # [b, hh, ww, c_q, d_q, c]

    negw = torch.full((b, hh, 1, 2, 2, c), float("-inf"), dtype=v.dtype, device=v.device)
    vp = torch.cat([negw, v, negw], dim=2)
    bothw = torch.maximum(v[:, :, :, :, 0], v[:, :, :, :, 1])
    h0 = torch.maximum(vp[:, :, 0:ww, :, 1], bothw)
    h1 = torch.maximum(bothw, vp[:, :, 2 : 2 + ww, :, 0])
    return torch.stack([h0, h1], dim=4).reshape(b, hh, ww, c4)


def _phase_matrix(n_out: int, n_in: int, factor: int, quadrant: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation rows for packed output index I of
    row-quadrant `quadrant`: src = (2I + q + 0.5)/factor - 0.5, edge-clamped
    (cv2 INTER_LINEAR half-pixel semantics)."""
    rows = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        src = (2 * i + quadrant + 0.5) / factor - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        rows[i, lo_c] += 1.0 - frac
        rows[i, hi_c] += frac
    return rows


@functools.lru_cache(maxsize=32)
def _phase_matrices(n_out: int, n_in: int, factor: int, device: str) -> torch.Tensor:
    """[2, n_out, n_in]: both quadrants' interpolation rows, on `device`."""
    m = np.stack([_phase_matrix(n_out, n_in, factor, q) for q in (0, 1)])
    return torch.from_numpy(m).to(device)


def s2d_upsample_mxu(g: torch.Tensor, factor: int) -> torch.Tensor:
    """s2d(resize_bilinear(g, factor*h, factor*w)) as two separable matrix
    products with static per-quadrant interpolation matrices:
    out_q(a, d) = A_y^(a) @ g @ A_x^(d)^T.
    g: [B, h, w, C] -> [B, factor*h/2, factor*w/2, 4C] (quadrant-major).
    In bf16 each product is summed in f32 and rounded to bf16, as the JAX
    package's ``mode=1`` einsums are (the matrices' entries are exact)."""
    if factor % 2 or factor < 2:
        raise ValueError(f"factor must be even and >= 2, got {factor}")
    b, h, w, c = g.shape
    hp, wp = factor * h // 2, factor * w // 2
    dev = str(g.device)
    ay = _phase_matrices(hp, h, factor, dev)  # [2, hp, h]
    ax = _phase_matrices(wp, w, factor, dev)  # [2, wp, w]
    t = bf16.einsum("api,bijc->bpajc", ay, g, g.dtype)
    o = bf16.einsum("dqj,bpajc->bpqadc", ax, t, g.dtype)
    return o.reshape(b, hp, wp, 4 * c)
