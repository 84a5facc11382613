"""The packed FAM, the dec1 chain and fam_dual_conv3 on CUDA kernels, with
their plain PyTorch versions.

Counterpart of the six kernels of ``retinex_tpu/ops/fused_blocks.py``:
five that the packed forward runs (``models/packed_inference.py``) and one
standalone op. The FAM kernels live in
``retinex_tpu_torch/csrc/fam_fused.cu``:

- ``fam_conv_fused`` (K4): the FAM's whole conv stage on the packed
  [B,h,w,128] input, the fusion 1x1 folded into each branch. On the card
  it is three launches, each with its own wrapper and plain version:
  ``fam_conv_y`` (y = relu(conv3(x, k1) + b1), 128 -> 256) and
  ``fam_conv_z`` (z = conv3(y, [k32; k42]) + bias_total, 256 -> 128) on
  ``csrc/conv_pipelined.cu``, then ``fam_conv_out`` (relu(z + x @ ka +
  maxpool3x3(x) @ kb), in ``csrc/fam_fused.cu``). The stages read the
  weights from ``pack_fam_conv``, which keeps them as given and in those
  kernels' layouts, made once per model (``models/packed_inference.py``);
- ``fam_tail_stats`` (K5): x * ca -> per-quadrant channel mean and max,
  [B,h,w,8] in the order (a0,m0,a1,m1,a2,m2,a3,m3), the SA conv's input;
- ``fam_tail_apply_g1`` (K6): (x * ca * sa of each quadrant) @ w, the
  attention tail with the following fusion slice folded in. One kernel in
  two instances: quadrant-block-diagonal w (the packed model's folds,
  packed once per model by ``pack_tail_g1``) and dense w;
- ``fam_tail_apply`` (K11): x * ca * sa of each quadrant, the attention
  tail at shapes whose fusion does not fold (1080-row frames);
- ``fam_dual_conv3`` (K12): y = relu(conv3x3(x, k1) + b1), then a 3x3
  conv on each 128-channel half of y, side by side. The FAM's branch 3/4
  chains before K4 folded them; the JAX package took it off its production
  graph and calls it as a standalone op (its tests, ``scripts/perf_lab.py``),
  in f32 or bf16: the kernels are cast to x.dtype, the biases stay f32, y is
  rounded to x.dtype before the second convs, and the output once more. On
  the card it is two launches, each with its own wrapper and plain version:
  ``fam_dual_y`` (y, 128 -> 256, stored at the image's size, so the next
  convolution's zero padding is the JAX kernel's edge mask) and
  ``fam_dual_out`` (the two half convolutions as one grouped convolution,
  groups = 2, on the stacked kernel [k2a | k2b]), both on
  ``csrc/conv_pipelined.cu`` in f32 and on ``csrc/conv_wgmma.cu`` in bf16,
  the weights packed on each call;

and ``dec1_chain`` (K10): the packed dec1 UpBlock (1x1 up-conv, two 3x3
conv-BN-ReLU stages, BN folded), the +x1p residual and the residual_conv.
Only ``NetCfg(dec1_chain=True)`` runs it. On the card it is four
``csrc/conv_pipelined.cu`` launches, each with its own wrapper and plain
version: ``dec1_up`` (the 1x1, 64 -> 128), ``dec1_c1``, ``dec1_c2`` (its
epilogue adds x1p after the ReLU) and ``dec1_rc``, reading the weights of
one ``pack_dec1_chain``, made once per model (``models/packed_inference.py``).

K4, K5, K6 and K11 also run in bf16, the ``--use_amp`` net's FAMs, rounded
where the JAX kernels round their bf16 instances (x.dtype bf16):

- K4: x, k1, k32, k42, ka and kb in bf16, the biases f32, every product
  summed in f32; y = relu(conv3(x, k1) + b1) rounded to bf16; z, the second
  convolution plus bias_total, NOT rounded (the JAX kernel sums all four
  branches in f32); the output rounded once. On the card ``fam_conv_y``
  and ``fam_conv_z`` run on ``csrc/conv_wgmma.cu`` (z in its f32-output
  mode) and ``fam_conv_out`` in its bf16 instance, from the weights of one
  ``pack_fam_conv(..., dtype=torch.bfloat16)``;
- K5: x * ca rounded to bf16, the quadrant means and maxima in f32, the
  output rounded to bf16;
- K11: x * ca rounded to bf16, then * sa rounded to bf16;
- K6: K11's two roundings, then an f32 product with the f32 w, the output
  rounded to bf16.

``ca_vec`` and K6's ``w`` stay f32 in bf16 too (the JAX kernels take them
so; ca is rounded to bf16 inside, exactly, as the net's ca is bf16); ``sa``
is in x's dtype. ``BF16_LAUNCHES`` counts the bf16 instances apart
(``fam_conv_fused_bf16``, ``fam_conv_y_bf16``, ..., ``fam_tail_apply_bf16``).

Activations are f32 NHWC (K4-K6, K11 and K12: f32 or bf16), kernels HWIO, ``ca_vec``
[B,128] (the 32-channel attention tiled per quadrant), ``sa`` [B,h,w,4]:
the JAX layouts, so the same numpy weights go to both packages. The TPU's
tile gates (``fam_conv_supported``, ``fam_tail_supported``,
``dec1_chain_supported``, ``fam_dual_supported``) have no counterpart: the
kernels take any h, w and batch.

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other. ``LAUNCHES`` counts
the calls of each public K-wrapper that launched its kernels
(``fam_conv_fused``, ``dec1_chain`` and ``fam_dual_conv3`` once per call),
``KERNEL_LAUNCHES`` the launches of K4's, K10's and K12's stages (K12's by
the kernel that served each: ``_pipelined`` in f32, ``_wgmma`` in bf16)
and of K6's two instances, so a run shows which kernels served them.
"""

from __future__ import annotations

import dataclasses

import torch

from retinex_tpu_torch.ops import _kernels
from retinex_tpu_torch.ops.conv_pallas import launch_pipelined, launch_wgmma, pack_pipelined, pack_wgmma
from retinex_tpu_torch.ops.s2d import conv_nhwc, hwio_to_oihw, maxpool3x3_s1_s2d

C = 128  # packed FAM width: 4 quadrants of 32 channels

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {
    "fam_conv_fused": 0, "fam_tail_stats": 0, "fam_tail_apply_g1": 0, "fam_tail_apply": 0, "dec1_chain": 0,
    "fam_dual_conv3": 0,
}
# Launches of K4's, K10's and K12's stages and of K6's two instances since
# the last reset_launches().
KERNEL_LAUNCHES = {
    "fam_conv_y": 0, "fam_conv_z": 0, "fam_conv_out": 0, "fam_tail_apply_g1_diag": 0, "fam_tail_apply_g1_dense": 0,
    "dec1_up": 0, "dec1_c1": 0, "dec1_c2": 0, "dec1_rc": 0,
    "fam_dual_y_pipelined": 0, "fam_dual_y_wgmma": 0, "fam_dual_out_pipelined": 0, "fam_dual_out_wgmma": 0,
}
# The bf16 instances of K4-K6 and K11 since the last reset_launches(): the
# wrappers' launches and the kernels' (K4's stages, K6's two instances),
# counted apart from the f32 ones above under the same names + "_bf16".
BF16_LAUNCHES = {
    "fam_conv_fused_bf16": 0, "fam_tail_stats_bf16": 0, "fam_tail_apply_g1_bf16": 0, "fam_tail_apply_bf16": 0,
    "fam_conv_y_bf16": 0, "fam_conv_z_bf16": 0, "fam_conv_out_bf16": 0, "fam_tail_apply_g1_diag_bf16": 0,
    "fam_tail_apply_g1_dense_bf16": 0,
}
_FAM_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES, BF16_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _count(table: dict, name: str, dtype: torch.dtype) -> None:
    """One launch of `name`'s `dtype` instance: in `table` (f32), or as
    ``name + "_bf16"`` in ``BF16_LAUNCHES``."""
    if dtype == torch.bfloat16:
        BF16_LAUNCHES[name + "_bf16"] += 1
    else:
        table[name] += 1


def _check(t: torch.Tensor, what: str, shape: tuple, device: torch.device, dtype=torch.float32) -> None:
    """Of `dtype` (f32 by default; a tuple: any of them), contiguous, on
    `device`, of `shape` (None matches any size)."""
    ok = t.ndim == len(shape) and all(s is None or s == d for s, d in zip(shape, t.shape))
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or not ok:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{what}: expected {names} {shape}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")


# ---------------------------------------------------------------- K4


@dataclasses.dataclass(frozen=True)
class FamConvPacked:
    """K4's weights, made once by ``pack_fam_conv``: as given (ka, kb [128,
    128]; k1 [3,3,128,256], b1 [256]; k32, k42 [3,3,128,128]; bias_total
    [128], all f32), which the plain versions read, and in the kernels'
    layouts for `dtype`: k1 and the stacked [k32; k42] as
    ``conv_pallas.pack_pipelined`` (f32) or ``pack_wgmma`` (bf16, rounded
    once) packs them, and [ka; kb] [256,128] in `dtype`."""

    ka: torch.Tensor
    kb: torch.Tensor
    k1: torch.Tensor
    b1: torch.Tensor
    k32: torch.Tensor
    k42: torch.Tensor
    bias_total: torch.Tensor
    k1_packed: torch.Tensor
    k2_packed: torch.Tensor
    kab_packed: torch.Tensor
    dtype: torch.dtype = torch.float32

    def weights(self) -> tuple:
        """The weights as given, in ``fam_conv_fused``'s order."""
        return self.ka, self.kb, self.k1, self.b1, self.k32, self.k42, self.bias_total


_K4_SHAPES = {
    "ka": (C, C), "kb": (C, C), "k1": (3, 3, C, 2 * C), "b1": (2 * C,), "k32": (3, 3, C, C), "k42": (3, 3, C, C),
    "bias_total": (C,),
}


def _check_k4_weights(weights, device, what: str) -> None:
    for t, (name, shape) in zip(weights, _K4_SHAPES.items()):
        _check(t, f"{what} {name}", shape, device)


def stack_second_convs(k32, k42) -> torch.Tensor:
    """[k32; k42]: conv3(y3, k32) + conv3(y4, k42) is one 3x3 convolution of
    y = (y3 | y4) with the kernels stacked along the input channels."""
    return torch.cat([k32, k42], dim=2)


def pack_fam_conv(ka, kb, k1, b1, k32, k42, bias_total, dtype: torch.dtype = torch.float32) -> FamConvPacked:
    """K4's weights in both forms, from one f32 set, for K4's `dtype`
    instance (once per model and dtype in ``models/packed_inference.py``)."""
    weights = (ka, kb, k1, b1, k32, k42, bias_total)
    _check_k4_weights(weights, ka.device, "pack_fam_conv")
    if dtype not in _FAM_DTYPES:
        raise ValueError(f"pack_fam_conv: dtype must be float32 or bfloat16, got {dtype}")
    pack = pack_pipelined if dtype == torch.float32 else pack_wgmma
    return FamConvPacked(
        *weights, k1_packed=pack(k1), k2_packed=pack(stack_second_convs(k32, k42)),
        kab_packed=torch.cat([ka, kb], dim=0).to(dtype).contiguous(), dtype=dtype,
    )


def _oihw_as(k: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """An HWIO kernel rounded to `dtype`, as an f32 OIHW tensor on `device`."""
    return hwio_to_oihw(k.to(dtype)).to(device)


def fam_conv_fused_plain(x, ka, kb, k1, b1, k32, k42, bias_total):
    """Plain version of K4: the folded composition
    relu(x@ka + maxpool3x3(x)@kb + conv3(y3,k32) + conv3(y4,k42) + bias_total),
    (y3|y4) = relu(conv3(x,k1) + b1), in f32 with the kernels rounded to
    x.dtype and, in bf16, y rounded to it and the output once more."""
    dt, xf, dev = x.dtype, x.float(), x.device
    mid = torch.relu(conv_nhwc(xf, _oihw_as(k1, dt, dev), b1, (1, 1))).to(dt).float()
    pooled = maxpool3x3_s1_s2d(xf)
    return torch.relu(
        xf @ ka.to(dt).float()
        + pooled @ kb.to(dt).float()
        + conv_nhwc(mid[..., :C], _oihw_as(k32, dt, dev), None, (1, 1))
        + conv_nhwc(mid[..., C:], _oihw_as(k42, dt, dev), None, (1, 1))
        + bias_total
    ).to(dt)


def fam_conv_y_plain(x, k1, b1):
    """Plain version of K4's first stage: relu(conv3(x, k1) + b1) in f32,
    the kernel rounded to x.dtype, y rounded to it once; K12's first stage
    (``fam_dual_y_plain``)."""
    return fam_dual_y_plain(x, k1, b1)


def fam_conv_z_plain(y, k2, bias_total):
    """Plain version of K4's second stage: conv3(y, k2) + bias_total, k2 the
    stacked [k32; k42] rounded to y.dtype, in f32 and left f32 (K4 never
    rounds z)."""
    return conv_nhwc(y.float(), _oihw_as(k2, y.dtype, y.device), bias_total, (1, 1))


def fam_conv_out_plain(z, x, ka, kb):
    """Plain version of K4's last stage: relu(z + x@ka + maxpool3x3(x)@kb),
    z f32, ka and kb rounded to x.dtype, in f32, rounded to x.dtype once."""
    dt, xf = x.dtype, x.float()
    return torch.relu(z + xf @ ka.to(dt).float() + maxpool3x3_s1_s2d(xf) @ kb.to(dt).float()).to(dt)


def fam_conv_staged_plain(x, ka, kb, k1, b1, k32, k42, bias_total):
    """K4 as its kernels compute it, each stage by its plain version."""
    y = fam_conv_y_plain(x, k1, b1)
    return fam_conv_out_plain(fam_conv_z_plain(y, stack_second_convs(k32, k42), bias_total), x, ka, kb)


def _check_k4_stage(t: torch.Tensor, what: str, channels: int, p: FamConvPacked) -> None:
    _check(t, what, (None, None, None, channels), p.ka.device, p.dtype)


def fam_conv_y(x, p: FamConvPacked):
    """K4's first stage, relu(conv3(x, k1) + b1): x [B,h,w,128] in
    ``p.dtype`` -> [B,h,w,256] in it, the weights from ``pack_fam_conv``:
    f32 on conv_pipelined, bf16 on conv_wgmma."""
    _check_k4_stage(x, "fam_conv_y x", C, p)
    if x.device.type == "cpu":
        return fam_conv_y_plain(x, p.k1, p.b1)
    if p.dtype == torch.float32:
        y = launch_pipelined(x, p.k1_packed, p.b1, 2 * C, 3, 3, True)
    else:
        y = launch_wgmma(x, p.k1_packed, p.b1, 2 * C, 3, 3, 1, 1, 1, True)
    _count(KERNEL_LAUNCHES, "fam_conv_y", p.dtype)
    return y


def fam_conv_z(y, p: FamConvPacked):
    """K4's second stage, conv3(y, [k32; k42]) + bias_total: y [B,h,w,256]
    in ``p.dtype`` -> [B,h,w,128] f32 (in bf16 too: z is not rounded), the
    weights from ``pack_fam_conv``: f32 on conv_pipelined, bf16 on
    conv_wgmma in its f32-output mode."""
    _check_k4_stage(y, "fam_conv_z y", 2 * C, p)
    if y.device.type == "cpu":
        return fam_conv_z_plain(y, stack_second_convs(p.k32, p.k42), p.bias_total)
    if p.dtype == torch.float32:
        z = launch_pipelined(y, p.k2_packed, p.bias_total, C, 3, 3, False)
    else:
        z = launch_wgmma(y, p.k2_packed, p.bias_total, C, 3, 3, 1, 1, 1, False, out_dtype=torch.float32)
    _count(KERNEL_LAUNCHES, "fam_conv_z", p.dtype)
    return z


def fam_conv_out(z, x, p: FamConvPacked):
    """K4's last stage, relu(z + x@ka + maxpool3x3(x)@kb): z [B,h,w,128]
    f32, x [B,h,w,128] in ``p.dtype``, x >= 0 (the kernel's zero halo stands
    in for the max pool's -inf padding), the weights from
    ``pack_fam_conv``; the output in ``p.dtype``."""
    _check_k4_stage(x, "fam_conv_out x", C, p)
    _check(z, "fam_conv_out z", tuple(x.shape), x.device)
    if x.device.type == "cpu":
        return fam_conv_out_plain(z, x, p.ka, p.kb)
    stream = _kernels.stream(x)
    for t, what in ((x, "x"), (z, "z")):
        if t.data_ptr() % 16:
            raise ValueError(f"fam_conv_out {what}: the kernel reads 16-byte aligned rows; got a view at {t.data_ptr():#x}")
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    _kernels.launch(
        "fam_conv_out", z.data_ptr(), x.data_ptr(), p.kab_packed.data_ptr(), out.data_ptr(), b, h, w,
        int(p.dtype == torch.bfloat16), stream,
    )
    _count(KERNEL_LAUNCHES, "fam_conv_out", p.dtype)
    return out


def fam_conv_fused(x, ka, kb, k1, b1, k32, k42, bias_total, packed: FamConvPacked | None = None):
    """K4: the FAM's whole conv stage, x [B,h,w,128] >= 0 (post-ReLU: the
    kernel's zero halo stands in for the max pool's -inf padding), f32 or
    bf16; the output in x.dtype.

    ka, kb [128,128] (branch 1/2 1x1s with their fusion slices folded in);
    k1 [3,3,128,256], b1 [256] (branch 3/4 first convs stacked); k32, k42
    [3,3,128,128] (second convs, fusion-folded); bias_total [128]; all f32.
    `packed`: ``pack_fam_conv`` of these very tensors for x.dtype, made once
    (the packed model's FAMs); packed on the call when None. On the card:
    ``fam_conv_y``, ``fam_conv_z``, ``fam_conv_out``."""
    weights = (ka, kb, k1, b1, k32, k42, bias_total)
    _check(x, "fam_conv_fused x", (None, None, None, C), x.device, _FAM_DTYPES)
    _check_k4_weights(weights, x.device, "fam_conv_fused")
    if packed is not None and any(a is not b for a, b in zip(packed.weights(), weights)):
        raise ValueError("fam_conv_fused: `packed` was not made by pack_fam_conv from these weights")
    if packed is not None and packed.dtype != x.dtype:
        raise ValueError(f"fam_conv_fused: `packed` is for {packed.dtype}, x is {x.dtype}")
    if x.device.type == "cpu":
        return fam_conv_fused_plain(x, *weights)
    _kernels.stream(x)  # a tensor off the card raises before any packing
    p = pack_fam_conv(*weights, dtype=x.dtype) if packed is None else packed
    out = fam_conv_out(fam_conv_z(fam_conv_y(x, p), p), x, p)
    _count(LAUNCHES, "fam_conv_fused", x.dtype)
    return out


# ---------------------------------------------------------------- K5


def _check_tail(x, ca_vec, sa, what: str) -> None:
    """x [B,h,w,128] f32 or bf16; ca_vec [B,128] f32; sa (where given)
    [B,h,w,4] in x.dtype; all on x's device."""
    dev = x.device
    _check(x, f"{what} x", (None, None, None, C), dev, _FAM_DTYPES)
    b, h, wd, _ = x.shape
    _check(ca_vec, f"{what} ca_vec", (b, C), dev)
    if sa is not None:
        _check(sa, f"{what} sa", (b, h, wd, 4), dev, x.dtype)


def fam_tail_stats_plain(x, ca_vec):
    """Plain version of K5: x * ca in x.dtype (ca rounded to it), the
    quadrant means and maxima in f32, rounded to x.dtype."""
    b, h, w, _ = x.shape
    blocks = (x * ca_vec.to(x.dtype)[:, None, None, :]).reshape(b, h, w, 4, C // 4).float()
    return torch.stack([blocks.mean(dim=-1), blocks.amax(dim=-1)], dim=-1).reshape(b, h, w, 8).to(x.dtype)


def fam_tail_stats(x, ca_vec):
    """K5: [B,h,w,128] x (f32 or bf16), [B,128] f32 ca -> [B,h,w,8] SA conv
    input (mean|max pairs per quadrant) in x.dtype."""
    _check_tail(x, ca_vec, None, "fam_tail_stats")
    if x.device.type == "cpu":
        return fam_tail_stats_plain(x, ca_vec)
    stream = _kernels.stream(x)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, 8), dtype=x.dtype, device=x.device)
    _kernels.launch(
        "fam_tail_stats", x.data_ptr(), ca_vec.data_ptr(), out.data_ptr(), b, h * w, int(x.dtype == torch.bfloat16),
        stream,
    )
    _count(LAUNCHES, "fam_tail_stats", x.dtype)
    return out


# ---------------------------------------------------------------- K6


def fam_tail_apply_g1_plain(x, ca_vec, sa, w):
    """Plain version of K6: K11's plain version, then its product with the
    f32 w in f32, rounded to x.dtype."""
    return (fam_tail_apply_plain(x, ca_vec, sa).float() @ w).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TailG1Packed:
    """K6's weights, made once by ``pack_tail_g1``: ``w`` [128, Cout] as
    given (the plain version reads it) and ``kernel_w`` in the kernel's
    layout: where ``diag`` (``w`` quadrant-block-diagonal), the four
    diagonal [32, 32] blocks stacked to [128, 32]; else ``w`` with zero
    columns up to 128. f32 for both of K6's element types."""

    w: torch.Tensor
    kernel_w: torch.Tensor
    diag: bool


def _is_quadrant_diagonal(w: torch.Tensor) -> bool:
    """[128, 128] with every entry outside the four [32, 32] diagonal
    blocks exactly zero."""
    if tuple(w.shape) != (C, C):
        return False
    q = C // 4
    off = w.reshape(4, q, 4, q).clone()
    off[torch.arange(4), :, torch.arange(4), :] = 0
    return not bool(off.any())


def _check_tail_g1_w(w: torch.Tensor, what: str, device: torch.device) -> int:
    """[128, Cout] f32 on `device`, Cout a multiple of 4 up to 128; returns Cout."""
    _check(w, what, (C, None), device)
    cout = w.shape[1]
    if cout % 4 or not 0 < cout <= C:
        raise ValueError(f"fam_tail_apply_g1: Cout must be a multiple of 4 in [4, {C}], got {cout}")
    return cout


def _dense_tail_g1(w: torch.Tensor) -> TailG1Packed:
    """`w` in the dense instance's layout: zero columns up to 128."""
    return TailG1Packed(w, torch.nn.functional.pad(w, (0, C - w.shape[1])).contiguous(), False)


def pack_tail_g1(w: torch.Tensor) -> TailG1Packed:
    """K6's weights in both forms (once per model in
    ``models/packed_inference.py``): inspects ``w`` here, never on a call."""
    _check_tail_g1_w(w, "pack_tail_g1 w", w.device)
    if not _is_quadrant_diagonal(w):
        return _dense_tail_g1(w)
    q = C // 4
    blocks = w.reshape(4, q, 4, q)[torch.arange(4), :, torch.arange(4), :]  # [4 (quadrant), 32, 32]
    return TailG1Packed(w, blocks.reshape(C, q).contiguous(), True)


def _check_tail_g1_packed(packed: TailG1Packed, w: torch.Tensor, device: torch.device) -> None:
    """`packed` was made from this very `w`, and its ``kernel_w`` has the
    layout its instance reads: [128, 32] where ``diag`` (Cout 128), else
    [128, 128]; f32, contiguous, on `device`."""
    if packed.w is not w:
        raise ValueError("fam_tail_apply_g1: `packed` was not made by pack_tail_g1 from this w")
    if packed.diag and w.shape[1] != C:
        raise ValueError(f"fam_tail_apply_g1: a quadrant-diagonal `packed` needs Cout {C}, got {w.shape[1]}")
    _check(packed.kernel_w, "fam_tail_apply_g1 packed.kernel_w", (C, C // 4 if packed.diag else C), device)


def fam_tail_apply_g1(x, ca_vec, sa, w, packed: TailG1Packed | None = None):
    """K6: [B,h,w,128] x (f32 or bf16), [B,128] f32 ca, [B,h,w,4] sa in
    x.dtype, [128,Cout] f32 w -> (x * ca * sa per quadrant) @ w,
    [B,h,w,Cout] in x.dtype. Cout: a multiple of 4 up to 128. `packed`:
    ``pack_tail_g1`` of this very `w`, made once (the packed model's fusion
    folds); when None, `w` is laid out for the dense instance on the call,
    without inspecting it. On the card the kernel's quadrant-diagonal
    instance serves a `packed` marked ``diag``, the dense instance any other
    call (``KERNEL_LAUNCHES``)."""
    dev = x.device
    _check_tail(x, ca_vec, sa, "fam_tail_apply_g1")
    b, h, wd, _ = x.shape
    cout = _check_tail_g1_w(w, "fam_tail_apply_g1 w", dev)
    if packed is not None:
        _check_tail_g1_packed(packed, w, dev)
    if dev.type == "cpu":
        return fam_tail_apply_g1_plain(x, ca_vec, sa, w)
    stream = _kernels.stream(x)
    for t, what in ((x, "x"), (sa, "sa")):  # cp.async copies whole rows: x's 16-byte chunks, sa's 4 values
        if t.data_ptr() % min(16, 4 * t.element_size()):
            raise ValueError(f"fam_tail_apply_g1 {what}: the kernel reads aligned rows; got a view at {t.data_ptr():#x}")
    p = _dense_tail_g1(w) if packed is None else packed
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=dev)
    if out.numel():
        _kernels.launch(
            "fam_tail_apply_g1", x.data_ptr(), ca_vec.data_ptr(), sa.data_ptr(), p.kernel_w.data_ptr(),
            out.data_ptr(), b, h * wd, cout, int(p.diag), int(x.dtype == torch.bfloat16), stream,
        )
        _count(KERNEL_LAUNCHES, "fam_tail_apply_g1_diag" if p.diag else "fam_tail_apply_g1_dense", x.dtype)
        _count(LAUNCHES, "fam_tail_apply_g1", x.dtype)
    return out


# ---------------------------------------------------------------- K11


def fam_tail_apply_plain(x, ca_vec, sa):
    """Plain version of K11: x * ca, then * sa, each in x.dtype (ca rounded
    to it)."""
    b, h, wd, _ = x.shape
    blocks = (x * ca_vec.to(x.dtype)[:, None, None, :]).reshape(b, h, wd, 4, C // 4)
    return (blocks * sa[..., None]).reshape(b, h, wd, C)


def fam_tail_apply(x, ca_vec, sa):
    """K11: [B,h,w,128] x (f32 or bf16), [B,128] f32 ca, [B,h,w,4] sa in
    x.dtype -> x * ca * sa per quadrant, [B,h,w,128] in x.dtype."""
    _check_tail(x, ca_vec, sa, "fam_tail_apply")
    if x.device.type == "cpu":
        return fam_tail_apply_plain(x, ca_vec, sa)
    stream = _kernels.stream(x)
    b, h, wd, _ = x.shape
    out = torch.empty_like(x)
    _kernels.launch(
        "fam_tail_apply", x.data_ptr(), ca_vec.data_ptr(), sa.data_ptr(), out.data_ptr(), b, h * wd,
        int(x.dtype == torch.bfloat16), stream,
    )
    _count(LAUNCHES, "fam_tail_apply", x.dtype)
    return out


# ---------------------------------------------------------------- K10

D2_C = 64  # dec1's input width (d2, unpacked)
_K10_SHAPES = {
    "k_up": (1, 1, D2_C, C), "b_up": (C,), "k_c1": (3, 3, C, C), "b_c1": (C,), "k_c2": (3, 3, C, C), "b_c2": (C,),
    "k_rc": (3, 3, C, C), "b_rc": (C,),
}


@dataclasses.dataclass(frozen=True)
class Dec1Packed:
    """K10's weights, made once by ``pack_dec1_chain``: the eight tensors as
    given (the plain versions read them; the biases, [128] f32 = Cout_pad,
    are also the kernels' padded biases) and each kernel as
    ``conv_pallas.pack_pipelined`` packs it."""

    k_up: torch.Tensor
    b_up: torch.Tensor
    k_c1: torch.Tensor
    b_c1: torch.Tensor
    k_c2: torch.Tensor
    b_c2: torch.Tensor
    k_rc: torch.Tensor
    b_rc: torch.Tensor
    up_packed: torch.Tensor
    c1_packed: torch.Tensor
    c2_packed: torch.Tensor
    rc_packed: torch.Tensor

    def weights(self) -> tuple:
        """The weights as given, in ``dec1_chain``'s order."""
        return self.k_up, self.b_up, self.k_c1, self.b_c1, self.k_c2, self.b_c2, self.k_rc, self.b_rc


def _check_k10_weights(weights, device, what: str) -> None:
    for t, (name, shape) in zip(weights, _K10_SHAPES.items()):
        _check(t, f"{what} {name}", shape, device)


def pack_dec1_chain(k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc) -> Dec1Packed:
    """K10's weights in both forms, from one set (once per model in
    ``models/packed_inference.py``)."""
    weights = (k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc)
    _check_k10_weights(weights, k_up.device, "pack_dec1_chain")
    return Dec1Packed(*weights, *(pack_pipelined(k) for k in (k_up, k_c1, k_c2, k_rc)))


def dec1_chain_plain(d2, x1p, k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc):
    """Plain version of K10: 1x1 + b_up; ReLU(3x3); ReLU(3x3) + x1p;
    ReLU(3x3), each 3x3 with 'SAME' zero padding."""
    dev = d2.device
    y = conv_nhwc(d2, hwio_to_oihw(k_up).to(dev), b_up)
    y = torch.relu(conv_nhwc(y, hwio_to_oihw(k_c1).to(dev), b_c1, (1, 1)))
    y = torch.relu(conv_nhwc(y, hwio_to_oihw(k_c2).to(dev), b_c2, (1, 1))) + x1p
    return torch.relu(conv_nhwc(y, hwio_to_oihw(k_rc).to(dev), b_rc, (1, 1)))


def dec1_up_plain(d2, k_up, b_up):
    """Plain version of K10's first stage: y1 = d2 @ k_up + b_up (a 1x1)."""
    return conv_nhwc(d2, hwio_to_oihw(k_up).to(d2.device), b_up)


def dec1_conv_plain(y, k, b, residual=None):
    """Plain version of K10's 3x3 stages: relu(conv3(y, k) + b), then
    + residual where given (``dec1_c2``'s x1p)."""
    out = torch.relu(conv_nhwc(y, hwio_to_oihw(k).to(y.device), b, (1, 1)))
    return out if residual is None else out + residual


def dec1_up(d2, p: Dec1Packed):
    """K10's first stage, d2 @ k_up + b_up: d2 [B,H,W,64] -> [B,H,W,128]."""
    _check(d2, "dec1_up d2", (None, None, None, D2_C), p.k_up.device)
    if d2.device.type == "cpu":
        return dec1_up_plain(d2, p.k_up, p.b_up)
    y = launch_pipelined(d2, p.up_packed, p.b_up, C, 1, 1, False)
    KERNEL_LAUNCHES["dec1_up"] += 1
    return y


def _dec1_conv(name: str, y, k, kp, b, residual=None):
    """One of K10's 3x3 stages on conv_pipelined (its epilogue adds the
    residual after the ReLU)."""
    _check(y, f"{name} y", (None, None, None, C), k.device)
    if residual is not None:
        _check(residual, f"{name} x1p", tuple(y.shape), y.device)
    if y.device.type == "cpu":
        return dec1_conv_plain(y, k, b, residual)
    out = launch_pipelined(y, kp, b, C, 3, 3, True, residual=residual)
    KERNEL_LAUNCHES[name] += 1
    return out


def dec1_c1(y1, p: Dec1Packed):
    """K10's second stage, relu(conv3(y1, k_c1) + b_c1), [B,H,W,128]."""
    return _dec1_conv("dec1_c1", y1, p.k_c1, p.c1_packed, p.b_c1)


def dec1_c2(y2, x1p, p: Dec1Packed):
    """K10's third stage, relu(conv3(y2, k_c2) + b_c2) + x1p, [B,H,W,128]."""
    return _dec1_conv("dec1_c2", y2, p.k_c2, p.c2_packed, p.b_c2, residual=x1p)


def dec1_rc(y3, p: Dec1Packed):
    """K10's last stage (the residual_conv), relu(conv3(y3, k_rc) + b_rc)."""
    return _dec1_conv("dec1_rc", y3, p.k_rc, p.rc_packed, p.b_rc)


def dec1_chain(d2, x1p, k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc, packed: Dec1Packed | None = None):
    """K10: r = relu(conv3x3(relu(conv3x3(relu(conv3x3(d2 @ k_up + b_up) + b_c1))
    + b_c2) + x1p) + b_rc), the BN affines folded into k_c1/b_c1, k_c2/b_c2.

    d2 [B,H,W,64]; x1p [B,H,W,128]; k_up [1,1,64,128]; k_c1, k_c2, k_rc
    [3,3,128,128] HWIO; biases [128]. Returns r [B,H,W,128]. `packed`:
    ``pack_dec1_chain`` of these very tensors, made once (the packed model's
    dec1); packed on the call when None. On the card: ``dec1_up``,
    ``dec1_c1``, ``dec1_c2``, ``dec1_rc``."""
    dev = d2.device
    weights = (k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc)
    _check(d2, "dec1_chain d2", (None, None, None, D2_C), dev)
    b, h, w, _ = d2.shape
    _check(x1p, "dec1_chain x1p", (b, h, w, C), dev)
    _check_k10_weights(weights, dev, "dec1_chain")
    if packed is not None and any(u is not v for u, v in zip(packed.weights(), weights)):
        raise ValueError("dec1_chain: `packed` was not made by pack_dec1_chain from these weights")
    if dev.type == "cpu":
        return dec1_chain_plain(d2, x1p, *weights)
    _kernels.stream(d2)  # a tensor off the card raises before any packing
    p = pack_dec1_chain(*weights) if packed is None else packed
    # Each intermediate is released once its consumer has been queued.
    y = dec1_c1(dec1_up(d2, p), p)
    y = dec1_c2(y, x1p, p)
    out = dec1_rc(y, p)
    LAUNCHES["dec1_chain"] += 1
    return out


# ---------------------------------------------------------------- K12

# K12's weights as fam_dual_conv3 takes them, and the stacked second-stage pair.
_K12_SHAPES = {"k1": (3, 3, C, 2 * C), "b1": (2 * C,), "k2a": (3, 3, C, C), "b2a": (C,), "k2b": (3, 3, C, C),
               "b2b": (C,), "k2": (3, 3, C, 2 * C), "b2": (2 * C,)}


def _check_dual(t: torch.Tensor, what: str, channels: int) -> None:
    """f32 or bf16 [B, H, W, channels], contiguous."""
    if t.dtype not in (torch.float32, torch.bfloat16) or t.ndim != 4 or t.shape[3] != channels:
        raise ValueError(f"{what}: expected float32 or bfloat16 [B, H, W, {channels}], got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_dual_weights(weights, names, device, what: str) -> None:
    for t, name in zip(weights, names):
        shape = _K12_SHAPES[name]
        if tuple(t.shape) != shape or not t.is_floating_point() or t.device != device:
            raise ValueError(f"{what} {name}: expected a float {shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stack_dual_convs(k2a, b2a, k2b, b2b) -> tuple[torch.Tensor, torch.Tensor]:
    """([k2a | k2b], [b2a | b2b]): the two half convolutions as one grouped
    convolution (groups = 2), the kernels stacked along the output channels."""
    return torch.cat([k2a, k2b], dim=3), torch.cat([b2a, b2b])


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


def fam_dual_y_plain(x, k1, b1):
    """Plain version of K12's first stage: relu(conv3(x, k1) + b1) in f32,
    the kernel rounded to x.dtype, y rounded to x.dtype once."""
    dt = x.dtype
    return torch.relu(conv_nhwc(x.float(), hwio_to_oihw(k1.to(dt)), b1.float(), (1, 1))).to(dt)


def fam_dual_out_plain(y, k2, b2):
    """Plain version of K12's second stage: conv3(y, k2) + b2 with groups =
    y's channels / k2's input channels (each group's share of Cout from its
    own input channels), in f32, rounded to y.dtype."""
    dt = y.dtype
    ci, groups = k2.shape[2], y.shape[3] // k2.shape[2]
    co = k2.shape[3] // groups
    yf = y.float()
    out = torch.cat(
        [
            conv_nhwc(yf[..., g * ci : (g + 1) * ci], hwio_to_oihw(k2[..., g * co : (g + 1) * co].to(dt)),
                      b2[g * co : (g + 1) * co].float(), (1, 1))
            for g in range(groups)
        ],
        dim=-1,
    )
    return out.to(dt).contiguous()


def _dual_stage(name: str, x, k, b, relu: bool, groups: int):
    """One of K12's stages on the card, a 3x3 convolution to 256 channels
    with the weights packed on the call: f32 on conv_pipelined, bf16 on
    conv_wgmma, counted as ``{name}_pipelined`` or ``{name}_wgmma``."""
    bias = b.float().contiguous()
    if x.dtype == torch.float32:
        out = launch_pipelined(x, pack_pipelined(k), bias, 2 * C, 3, 3, relu, groups=groups)
        KERNEL_LAUNCHES[f"{name}_pipelined"] += 1
    else:
        out = launch_wgmma(x, pack_wgmma(k), bias, 2 * C, 3, 3, 1, 1, 1, relu, groups=groups)
        KERNEL_LAUNCHES[f"{name}_wgmma"] += 1
    return out


def fam_dual_y(x, k1, b1):
    """K12's first stage, relu(conv3(x, k1) + b1) rounded to x.dtype: x
    [B,H,W,128] f32 or bf16 (16-byte aligned on the card), k1 [3,3,128,256],
    b1 [256] -> [B,H,W,256]. On the card f32 runs on conv_pipelined, bf16 on
    conv_wgmma; the weights are packed on the call."""
    _check_dual(x, "fam_dual_y x", C)
    _check_dual_weights((k1, b1), ("k1", "b1"), x.device, "fam_dual_y")
    if x.device.type == "cpu":
        return fam_dual_y_plain(x, k1, b1)
    return _dual_stage("fam_dual_y", x, k1, b1, relu=True, groups=1)


def fam_dual_out(y, k2, b2):
    """K12's second stage, the two half convolutions as one grouped
    convolution: conv3(y[..., :128], k2[..., :128]) | conv3(y[..., 128:],
    k2[..., 128:]) + b2, rounded to y.dtype. y [B,H,W,256] f32 or bf16
    (16-byte aligned on the card), k2 = [k2a | k2b] [3,3,128,256], b2 [256]
    (``stack_dual_convs``) -> [B,H,W,256]. On the card f32 runs on
    conv_pipelined, bf16 on conv_wgmma, groups = 2; the weights are packed
    on the call."""
    _check_dual(y, "fam_dual_out y", 2 * C)
    _check_dual_weights((k2, b2), ("k2", "b2"), y.device, "fam_dual_out")
    if y.device.type == "cpu":
        return fam_dual_out_plain(y, k2, b2)
    return _dual_stage("fam_dual_out", y, k2, b2, relu=False, groups=2)


def fam_dual_conv3(x, k1, b1, k2a, b2a, k2b, b2b):
    """K12: out = conv3x3(y[..., :128], k2a) + b2a | conv3x3(y[..., 128:], k2b)
    + b2b, y = relu(conv3x3(x, k1) + b1), each 3x3 with 'SAME' zero padding.

    x [B,H,W,128] f32 or bf16; k1 [3,3,128,256], k2a, k2b [3,3,128,128]
    (cast to x.dtype); b1 [256], b2a, b2b [128] (f32). Returns [B,H,W,256]
    in x.dtype. On the card: ``fam_dual_y``, then ``fam_dual_out``; x's
    base must be 16-byte aligned there."""
    weights = (k1, b1, k2a, b2a, k2b, b2b)
    _check_dual(x, "fam_dual_conv3 x", C)
    _check_dual_weights(weights, ("k1", "b1", "k2a", "b2a", "k2b", "b2b"), x.device, "fam_dual_conv3")
    if x.device.type == "cpu":
        return fam_dual_conv3_plain(x, *weights)
    _kernels.stream(x)  # a tensor off the card raises before any packing
    # y is released once fam_dual_out has been queued.
    out = fam_dual_out(fam_dual_y(x, k1, b1), *stack_dual_convs(k2a, b2a, k2b, b2b))
    LAUNCHES["fam_dual_conv3"] += 1
    return out
