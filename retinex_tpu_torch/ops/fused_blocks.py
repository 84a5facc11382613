"""The packed FAM, the dec1 chain and fam_dual_conv3 on six CUDA kernels,
with their plain PyTorch versions.

Counterpart of the six kernels of ``retinex_tpu/ops/fused_blocks.py``:
five that the packed forward runs (``models/packed_inference.py``) and one
standalone op. The FAM kernels live in
``retinex_tpu_torch/csrc/fam_fused.cu``:

- ``fam_conv_fused`` (K4): the FAM's whole conv stage on the packed
  [B,h,w,128] input, the fusion 1x1 folded into each branch;
- ``fam_tail_stats`` (K5): x * ca -> per-quadrant channel mean and max,
  [B,h,w,8] in the order (a0,m0,a1,m1,a2,m2,a3,m3), the SA conv's input;
- ``fam_tail_apply_g1`` (K6): (x * ca * sa of each quadrant) @ w, the
  attention tail with the following fusion slice folded in;
- ``fam_tail_apply`` (K11): x * ca * sa of each quadrant, the attention
  tail at shapes whose fusion does not fold (1080-row frames);
- ``fam_dual_conv3`` (K12): y = relu(conv3x3(x, k1) + b1), then a 3x3
  conv on each 128-channel half of y, side by side. The FAM's branch 3/4
  chains before K4 folded them; the JAX package took it off its production
  graph and calls it as a standalone op (its tests, ``scripts/perf_lab.py``),
  in f32 or bf16: the kernels are cast to x.dtype, the biases stay f32, y is
  rounded to x.dtype before the second convs, and the output once more.

and ``dec1_chain`` (K10) in ``retinex_tpu_torch/csrc/dec1_chain.cu``: the
packed dec1 UpBlock (1x1 up-conv, two 3x3 conv-BN-ReLU stages, BN folded),
the +x1p residual and the residual_conv, in one pass. Only
``NetCfg(dec1_chain=True)`` runs it.

Activations are f32 NHWC (K12: f32 or bf16), kernels HWIO, ``ca_vec``
[B,128] (the 32-channel attention tiled per quadrant), ``sa`` [B,h,w,4]:
the JAX layouts, so the same numpy weights go to both packages. The TPU's
tile gates (``fam_conv_supported``, ``fam_tail_supported``,
``dec1_chain_supported``, ``fam_dual_supported``) have no counterpart: the
kernels take any h, w and batch.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from retinex_tpu_torch.ops import _kernels
from retinex_tpu_torch.ops.s2d import conv_nhwc, hwio_to_oihw, maxpool3x3_s1_s2d

C = 128  # packed FAM width: 4 quadrants of 32 channels

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {
    "fam_conv_fused": 0, "fam_tail_stats": 0, "fam_tail_apply_g1": 0, "fam_tail_apply": 0, "dec1_chain": 0,
    "fam_dual_conv3": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(t: torch.Tensor, what: str, shape: tuple, device: torch.device) -> None:
    """f32, contiguous, on `device`, of `shape` (None matches any size)."""
    ok = t.ndim == len(shape) and all(s is None or s == d for s, d in zip(shape, t.shape))
    if t.dtype != torch.float32 or not ok:
        raise ValueError(f"{what}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")


def _stream(x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel path takes CUDA tensors, the plain path CPU tensors")
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------- K4


def fam_conv_fused_plain(x, ka, kb, k1, b1, k32, k42, bias_total):
    """Plain version of K4: the folded composition
    relu(x@ka + maxpool3x3(x)@kb + conv3(y3,k32) + conv3(y4,k42) + bias_total),
    (y3|y4) = relu(conv3(x,k1) + b1)."""
    mid = torch.relu(conv_nhwc(x, hwio_to_oihw(k1).to(x.device), b1, (1, 1)))
    pooled = maxpool3x3_s1_s2d(x)
    return torch.relu(
        x @ ka
        + pooled @ kb
        + conv_nhwc(mid[..., :C], hwio_to_oihw(k32).to(x.device), None, (1, 1))
        + conv_nhwc(mid[..., C:], hwio_to_oihw(k42).to(x.device), None, (1, 1))
        + bias_total
    )


def fam_conv_fused(x, ka, kb, k1, b1, k32, k42, bias_total):
    """K4: the FAM's whole conv stage, x [B,h,w,128] >= 0 (post-ReLU: the
    kernel's zero halo stands in for the max pool's -inf padding).

    ka, kb [128,128] (branch 1/2 1x1s with their fusion slices folded in);
    k1 [3,3,128,256], b1 [256] (branch 3/4 first convs stacked); k32, k42
    [3,3,128,128] (second convs, fusion-folded); bias_total [128]."""
    dev = x.device
    _check(x, "fam_conv_fused x", (None, None, None, C), dev)
    for t, what, shape in (
        (ka, "ka", (C, C)), (kb, "kb", (C, C)), (k1, "k1", (3, 3, C, 2 * C)), (b1, "b1", (2 * C,)),
        (k32, "k32", (3, 3, C, C)), (k42, "k42", (3, 3, C, C)), (bias_total, "bias_total", (C,)),
    ):
        _check(t, f"fam_conv_fused {what}", shape, dev)
    if dev.type == "cpu":
        return fam_conv_fused_plain(x, ka, kb, k1, b1, k32, k42, bias_total)
    stream = _stream(x)
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    _kernels.launch(
        "fam_conv_fused", x.data_ptr(), ka.data_ptr(), kb.data_ptr(), k1.data_ptr(), b1.data_ptr(),
        k32.data_ptr(), k42.data_ptr(), bias_total.data_ptr(), out.data_ptr(), b, h, w, stream,
    )
    LAUNCHES["fam_conv_fused"] += 1
    return out


# ---------------------------------------------------------------- K5


def fam_tail_stats_plain(x, ca_vec):
    """Plain version of K5."""
    b, h, w, _ = x.shape
    blocks = (x * ca_vec[:, None, None, :]).reshape(b, h, w, 4, C // 4)
    return torch.stack([blocks.mean(dim=-1), blocks.amax(dim=-1)], dim=-1).reshape(b, h, w, 8)


def fam_tail_stats(x, ca_vec):
    """K5: [B,h,w,128] x, [B,128] ca -> [B,h,w,8] SA conv input (mean|max
    pairs per quadrant)."""
    dev = x.device
    _check(x, "fam_tail_stats x", (None, None, None, C), dev)
    _check(ca_vec, "fam_tail_stats ca_vec", (x.shape[0], C), dev)
    if dev.type == "cpu":
        return fam_tail_stats_plain(x, ca_vec)
    stream = _stream(x)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, 8), dtype=torch.float32, device=dev)
    _kernels.launch("fam_tail_stats", x.data_ptr(), ca_vec.data_ptr(), out.data_ptr(), b, h * w, stream)
    LAUNCHES["fam_tail_stats"] += 1
    return out


# ---------------------------------------------------------------- K6


def fam_tail_apply_g1_plain(x, ca_vec, sa, w):
    """Plain version of K6."""
    return fam_tail_apply_plain(x, ca_vec, sa) @ w


def fam_tail_apply_g1(x, ca_vec, sa, w):
    """K6: [B,h,w,128] x, [B,128] ca, [B,h,w,4] sa, [128,Cout] w ->
    (x * ca * sa per quadrant) @ w, [B,h,w,Cout]. Cout: a multiple of 4 up
    to 128."""
    dev = x.device
    _check(x, "fam_tail_apply_g1 x", (None, None, None, C), dev)
    b, h, wd, _ = x.shape
    _check(ca_vec, "fam_tail_apply_g1 ca_vec", (b, C), dev)
    _check(sa, "fam_tail_apply_g1 sa", (b, h, wd, 4), dev)
    _check(w, "fam_tail_apply_g1 w", (C, None), dev)
    cout = w.shape[1]
    if cout % 4 or not 0 < cout <= C:
        raise ValueError(f"fam_tail_apply_g1: Cout must be a multiple of 4 in [4, {C}], got {cout}")
    if dev.type == "cpu":
        return fam_tail_apply_g1_plain(x, ca_vec, sa, w)
    stream = _stream(x)
    out = torch.empty((b, h, wd, cout), dtype=torch.float32, device=dev)
    _kernels.launch(
        "fam_tail_apply_g1", x.data_ptr(), ca_vec.data_ptr(), sa.data_ptr(), w.data_ptr(), out.data_ptr(),
        b, h * wd, cout, stream,
    )
    LAUNCHES["fam_tail_apply_g1"] += 1
    return out


# ---------------------------------------------------------------- K11


def fam_tail_apply_plain(x, ca_vec, sa):
    """Plain version of K11."""
    b, h, wd, _ = x.shape
    blocks = (x * ca_vec[:, None, None, :]).reshape(b, h, wd, 4, C // 4)
    return (blocks * sa[..., None]).reshape(b, h, wd, C)


def fam_tail_apply(x, ca_vec, sa):
    """K11: [B,h,w,128] x, [B,128] ca, [B,h,w,4] sa -> x * ca * sa per
    quadrant, [B,h,w,128]."""
    dev = x.device
    _check(x, "fam_tail_apply x", (None, None, None, C), dev)
    b, h, wd, _ = x.shape
    _check(ca_vec, "fam_tail_apply ca_vec", (b, C), dev)
    _check(sa, "fam_tail_apply sa", (b, h, wd, 4), dev)
    if dev.type == "cpu":
        return fam_tail_apply_plain(x, ca_vec, sa)
    stream = _stream(x)
    out = torch.empty_like(x)
    _kernels.launch("fam_tail_apply", x.data_ptr(), ca_vec.data_ptr(), sa.data_ptr(), out.data_ptr(), b, h * wd, stream)
    LAUNCHES["fam_tail_apply"] += 1
    return out


# ---------------------------------------------------------------- K10

D2_C = 64  # dec1's input width (d2, unpacked)


def dec1_chain_plain(d2, x1p, k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc):
    """Plain version of K10: 1x1 + b_up; ReLU(3x3); ReLU(3x3) + x1p;
    ReLU(3x3), each 3x3 with 'SAME' zero padding."""
    dev = d2.device
    y = conv_nhwc(d2, hwio_to_oihw(k_up).to(dev), b_up)
    y = torch.relu(conv_nhwc(y, hwio_to_oihw(k_c1).to(dev), b_c1, (1, 1)))
    y = torch.relu(conv_nhwc(y, hwio_to_oihw(k_c2).to(dev), b_c2, (1, 1))) + x1p
    return torch.relu(conv_nhwc(y, hwio_to_oihw(k_rc).to(dev), b_rc, (1, 1)))


def dec1_chain(d2, x1p, k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc):
    """K10: r = relu(conv3x3(relu(conv3x3(relu(conv3x3(d2 @ k_up + b_up) + b_c1))
    + b_c2) + x1p) + b_rc), the BN affines folded into k_c1/b_c1, k_c2/b_c2.

    d2 [B,H,W,64]; x1p [B,H,W,128]; k_up [1,1,64,128]; k_c1, k_c2, k_rc
    [3,3,128,128] HWIO; biases [128]. Returns r [B,H,W,128]."""
    dev = d2.device
    _check(d2, "dec1_chain d2", (None, None, None, D2_C), dev)
    b, h, w, _ = d2.shape
    _check(x1p, "dec1_chain x1p", (b, h, w, C), dev)
    for t, what, shape in (
        (k_up, "k_up", (1, 1, D2_C, C)), (b_up, "b_up", (C,)),
        (k_c1, "k_c1", (3, 3, C, C)), (b_c1, "b_c1", (C,)),
        (k_c2, "k_c2", (3, 3, C, C)), (b_c2, "b_c2", (C,)),
        (k_rc, "k_rc", (3, 3, C, C)), (b_rc, "b_rc", (C,)),
    ):
        _check(t, f"dec1_chain {what}", shape, dev)
    if dev.type == "cpu":
        return dec1_chain_plain(d2, x1p, k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc)
    stream = _stream(d2)
    out = torch.empty_like(x1p)
    _kernels.launch(
        "dec1_chain", d2.data_ptr(), x1p.data_ptr(), k_up.data_ptr(), b_up.data_ptr(), k_c1.data_ptr(),
        b_c1.data_ptr(), k_c2.data_ptr(), b_c2.data_ptr(), k_rc.data_ptr(), b_rc.data_ptr(), out.data_ptr(),
        b, h, w, stream,
    )
    LAUNCHES["dec1_chain"] += 1
    return out


# ---------------------------------------------------------------- K12


def fam_dual_conv3_plain(x, k1, b1, k2a, b2a, k2b, b2b):
    """Plain version of K12, in f32 with K12's two roundings to x.dtype."""
    dt = x.dtype
    oihw = lambda k: hwio_to_oihw(k.to(dt))  # noqa: E731
    y = torch.relu(conv_nhwc(x.float(), oihw(k1), b1.float(), (1, 1))).to(dt).float()
    out = torch.cat(
        [conv_nhwc(y[..., :C], oihw(k2a), b2a.float(), (1, 1)), conv_nhwc(y[..., C:], oihw(k2b), b2b.float(), (1, 1))],
        dim=-1,
    )
    return out.to(dt).contiguous()


def fam_dual_conv3(x, k1, b1, k2a, b2a, k2b, b2b):
    """K12: out = conv3x3(y[..., :128], k2a) + b2a | conv3x3(y[..., 128:], k2b)
    + b2b, y = relu(conv3x3(x, k1) + b1), each 3x3 with 'SAME' zero padding.

    x [B,H,W,128] f32 or bf16; k1 [3,3,128,256], k2a, k2b [3,3,128,128]
    (cast to x.dtype); b1 [256], b2a, b2b [128] (f32). Returns [B,H,W,256]
    in x.dtype."""
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 4 or x.shape[3] != C:
        raise ValueError(f"fam_dual_conv3 x: expected float32 or bfloat16 [B, H, W, {C}], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fam_dual_conv3 x: tensor must be contiguous")
    for t, what, shape in (
        (k1, "k1", (3, 3, C, 2 * C)), (b1, "b1", (2 * C,)), (k2a, "k2a", (3, 3, C, C)), (b2a, "b2a", (C,)),
        (k2b, "k2b", (3, 3, C, C)), (b2b, "b2b", (C,)),
    ):
        if tuple(t.shape) != shape or not t.is_floating_point() or t.device != dev:
            raise ValueError(f"fam_dual_conv3 {what}: expected a float {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return fam_dual_conv3_plain(x, k1, b1, k2a, b2a, k2b, b2b)
    stream = _stream(x)
    b, h, w, _ = x.shape
    ks = [k.to(x.dtype).contiguous() for k in (k1, k2a, k2b)]
    bs = [t.float().contiguous() for t in (b1, b2a, b2b)]
    out = torch.empty((b, h, w, 2 * C), dtype=x.dtype, device=dev)
    _kernels.launch(
        "fam_dual_conv3", x.data_ptr(), ks[0].data_ptr(), bs[0].data_ptr(), ks[1].data_ptr(), bs[1].data_ptr(),
        ks[2].data_ptr(), bs[2].data_ptr(), out.data_ptr(), b, h, w, int(x.dtype == torch.bfloat16), stream,
    )
    LAUNCHES["fam_dual_conv3"] += 1
    return out
