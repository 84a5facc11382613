"""Stride-1 convolutions on three CUDA kernels, with their plain PyTorch versions.

Counterpart of ``retinex_tpu/ops/conv_pallas.py``; the name is kept so a
reader finds it, but nothing here is Pallas. The JAX package took these
convolutions off its production graph (``models/packed_inference.py``); its
tests and ``scripts/perf_lab.py`` call them as standalone ops, and so may a
user of the port. Three public functions, with the JAX signatures, NHWC
activations and HWIO kernels:

- ``conv2d_pallas`` (K13): torch-parity padding, (k//2, k-1-k//2) on each
  spatial axis, so an even kernel pads one more row (column) above (left)
  than below (right); kernels up to 3x3;
- ``conv2d_pallas_im2col`` (K15): the same function (on the TPU a
  single-GEMM schedule of K13);
- ``conv2d_narrow`` (K14): a square 3x3 or 5x5 kernel, dilation 1 or 2,
  symmetric padding (k//2) * dilation.

Which kernel serves a CUDA call (``route``):

- every bf16 call (K13, K15 and K14) with Cin % 8 == 0 and x's base
  16-byte aligned: ``conv_wgmma`` (``csrc/conv_wgmma.cu``), an implicit
  GEMM on the tensor cores (TMA halo tiles, ``wgmma``). TMA needs 16-byte
  strides and base. Its K chunk is 32 channels where Cin <= 32 (K14's
  narrow convolutions), else 64. Every kernel size and dilation of the
  three wrappers has a shared-memory plan there (``conv_wgmma_plan``), so
  Cin, Cout and the kernel's shape never send a call elsewhere;
- K13 and K15 in f32 with Cin % 4 == 0 and x's base 16-byte aligned:
  ``conv_pipelined`` (``csrc/conv_pipelined.cu``), CUDA-core FMAs fed by a
  double-buffered ``cp.async`` pipeline (16-byte copies). TF32 stays off,
  by the parity rule;
- K14 in f32 with Cin % 4 == 0 and x's base 16-byte aligned:
  ``conv_narrow`` (``csrc/conv_narrow.cu``), CUDA-core FMAs on a Cout tile
  of 32, 64 or 128 (``cout_tile``), fed by a two- or three-stage
  ``cp.async`` pipeline that a persistent grid runs across its tiles; the
  kernel size and dilation are instances of their own;
- every other call (other Cin, a misaligned view): ``conv_direct``
  (``csrc/conv_direct.cu``), which takes any Cin and alignment.

Each wrapper keeps its own count in ``LAUNCHES``, and each kernel its count
in ``KERNEL_LAUNCHES``, so a run shows which kernel served which call.
Numbers follow the JAX functions: x is f32 or bf16, the kernel is cast to
x.dtype, the bias stays f32 (``None`` means zeros), the products accumulate
in f32, then the bias, the optional ReLU, and one rounding to x.dtype. The
TPU's gates (``conv_pallas_supported``, ``conv_narrow_supported``: channel
multiples of 128, 8-aligned tiles, "1x1 is faster in XLA") have no
counterpart: any B, H, W, Cin and Cout run.

The weights are plain arrays in the JAX layouts (HWIO kernel, f32 bias),
so the same numpy arrays go to both packages and ``models/convert.py``
needs nothing for them. Each wrapper packs the kernel for its kernel's
layout on every call (``pack_wgmma``, ``pack_pipelined``, ``pack_narrow``;
x is never copied).

Each wrapper takes a CPU tensor to its plain version and a CUDA tensor to
its kernel; there is no fallback from one to the other.

``launch_pipelined`` and ``launch_wgmma`` are the one launch site of each
tensor-core-free and tensor-core convolution. Besides the public functions
above, K12's and K10's stages (``ops/fused_blocks.py``) call them, with
two options no public function exposes: ``groups`` (Cout tile t reads only
its group's Cin / groups input channels, an HWIO kernel [kh, kw, Cin /
groups, Cout]) and a ``residual`` added after the bias and the ReLU (on
``conv_wgmma`` in f32 before the one rounding to bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from retinex_tpu_torch.ops import _kernels

# Kernel launches per wrapper, and per kernel, since the last reset_launches().
LAUNCHES = {"conv2d_pallas": 0, "conv2d_pallas_im2col": 0, "conv2d_narrow": 0}
KERNEL_LAUNCHES = {"conv_direct": 0, "conv_wgmma": 0, "conv_pipelined": 0, "conv_narrow": 0}

# conv_direct's tiling: input channels staged per pass; its output channels
# of one block are ``cout_tile(Cout)``.
CIN_CHUNK = 32
# conv_wgmma's N (the GEMM's Cout tile) is ``cout_tile(Cout)``; its K chunk
# is ``wgmma_chunk(Cin)``.
# conv_pipelined: input channels per stage, output channels per block.
PIPE_CHUNK = 8
PIPE_COT = 128
# conv_narrow: input channels per stage; its Cout tile is cout_tile(Cout).
NARROW_CHUNK = 8
_DTYPES = (torch.float32, torch.bfloat16)
_SAME = ("conv2d_pallas", "conv2d_pallas_im2col")


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def route(name: str, dtype: torch.dtype, cin: int, data_ptr: int) -> str:
    """The kernel that serves wrapper `name` on a CUDA x of `dtype` with
    `cin` channels at address `data_ptr` (see the module docstring)."""
    if data_ptr % 16 == 0:
        if dtype == torch.bfloat16 and cin % 8 == 0:
            return "conv_wgmma"
        if dtype == torch.float32 and cin % 4 == 0:
            return "conv_pipelined" if name in _SAME else "conv_narrow"
    return "conv_direct"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cout_tile(cout: int) -> int:
    """The Cout tile of conv_direct, conv_wgmma (its N) and conv_narrow: the
    smallest of 32, 64, 128 that holds Cout (128 for a wider Cout, in
    several tiles)."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 128


def wgmma_chunk(cin: int) -> int:
    """conv_wgmma's K chunk: 32 input channels (64-byte rows) where Cin <= 32,
    else 64 (128-byte rows)."""
    return 32 if cin <= 32 else 64


def pack_wgmma(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [kh, kw, Cin, Cout] -> bf16 [kh * kw, Cin chunks, Cout_pad, CK]:
    K-major B tiles of CK = wgmma_chunk(Cin) input channels, zeros past Cin
    and Cout."""
    kh, kw, cin, cout = kernel.shape
    ck = wgmma_chunk(cin)
    cin_pad = _round_up(cin, ck)
    cout_pad = _round_up(cout, cout_tile(cout))
    wk = F.pad(kernel.to(torch.bfloat16), (0, cout_pad - cout, 0, cin_pad - cin))
    return wk.reshape(kh * kw, cin_pad // ck, ck, cout_pad).transpose(2, 3).contiguous()


def pack_pipelined(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [kh, kw, Cin, Cout] -> f32 [Cin chunks, kh * kw, 8, Cout_pad]:
    one chunk's weights for every tap contiguous, zeros past Cin and Cout."""
    kh, kw, cin, cout = kernel.shape
    cin_pad = _round_up(cin, PIPE_CHUNK)
    cout_pad = _round_up(cout, PIPE_COT)
    wk = F.pad(kernel.float(), (0, cout_pad - cout, 0, cin_pad - cin))
    return wk.reshape(kh * kw, cin_pad // PIPE_CHUNK, PIPE_CHUNK, cout_pad).transpose(0, 1).contiguous()


def pack_narrow(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [k, k, Cin, Cout] -> f32 [Cout tiles, Cin chunks, k * k, 8, cot]
    (cot = ``cout_tile(Cout)``): one (Cout tile, chunk) run of weights for
    every tap contiguous, zeros past Cin and Cout."""
    kh, kw, cin, cout = kernel.shape
    cot = cout_tile(cout)
    cin_pad = _round_up(cin, NARROW_CHUNK)
    cout_pad = _round_up(cout, cot)
    wk = F.pad(kernel.float(), (0, cout_pad - cout, 0, cin_pad - cin))
    wk = wk.reshape(kh * kw, cin_pad // NARROW_CHUNK, NARROW_CHUNK, cout_pad // cot, cot)
    return wk.permute(3, 1, 0, 2, 4).contiguous()


def narrow_plan(cout: int, k: int, dilation: int) -> dict:
    """conv_narrow's instance for a call: its Cout tile, dynamic shared
    memory per block, pipeline stages, blocks per SM, registers and local
    (spilled) bytes per thread. Builds the kernels."""
    import ctypes

    cot = cout_tile(cout)
    plan = (ctypes.c_int * 5)()
    err = _kernels.query("conv_narrow_plan", cot, k, dilation, ctypes.addressof(plan))
    if err:
        raise ValueError(f"conv_narrow has no instance for Cout {cout}, {k}x{k}, dilation {dilation}: cudaError {err}")
    return {"cot": cot, "smem": plan[0], "stages": plan[1], "blocks_per_sm": plan[2], "registers": plan[3],
            "local_bytes": plan[4]}


def launch_narrow(x, wk, bk, cout: int, k: int, dilation: int, relu: bool) -> torch.Tensor:
    """conv_narrow on a CUDA f32 x [B,H,W,Cin] (Cin % 4 == 0, 16-byte
    aligned): wk the k x k kernel as ``pack_narrow`` packs it, bk an f32 bias
    [Cout rounded up to its tile], padding (k//2) * dilation, optional ReLU.
    Returns [B,H,W,Cout] f32."""
    b, h, w, cin = x.shape
    if x.dtype != torch.float32 or cin % 4 or x.data_ptr() % 16:
        raise ValueError(f"conv_narrow: expected a 16-byte aligned float32 x, Cin % 4 == 0; got {x.dtype}, Cin {cin}")
    cot = cout_tile(cout)
    cout_pad = _round_up(cout, cot)
    shape = (cout_pad // cot, _round_up(cin, NARROW_CHUNK) // NARROW_CHUNK, k * k, NARROW_CHUNK, cot)
    _check_packed("conv_narrow", x, [(wk, "kernel", shape, torch.float32), (bk, "bias", (cout_pad,), torch.float32)])
    stream = _kernels.stream(x)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    _kernels.launch("conv_narrow_f32", x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
                    k, dilation, int(relu), cot, stream)
    return out


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, what: str) -> None:
    if x.dtype not in _DTYPES or x.ndim != 4:
        raise ValueError(f"{what}: expected float32 or bfloat16 [B, H, W, Cin], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if kernel.ndim != 4 or kernel.shape[2] != x.shape[3] or not kernel.is_floating_point():
        raise ValueError(f"{what}: expected a float kernel [kh, kw, {x.shape[3]}, Cout], got {kernel.dtype} {tuple(kernel.shape)}")
    if bias is not None and (tuple(bias.shape) != (kernel.shape[3],) or not bias.is_floating_point()):
        raise ValueError(f"{what}: expected a float bias [{kernel.shape[3]}], got {bias.dtype} {tuple(bias.shape)}")
    for t in (kernel, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: weights on {t.device}, expected {x.device}")


def _torch_pad(k: int) -> tuple[int, int]:
    """(low, high) zero padding of a k-tap axis: k//2 before, k-1-k//2 after."""
    return k // 2, k - 1 - k // 2


def _conv_plain(x, kernel, bias, relu, pad_h, pad_w, dilation) -> torch.Tensor:
    """f32 convolution of x with the kernel rounded to x.dtype, + bias,
    optional ReLU, one rounding to x.dtype."""
    k = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
    xc = F.pad(x.float().permute(0, 3, 1, 2), (*pad_w, *pad_h))
    b = None if bias is None else bias.float()
    out = F.conv2d(xc, k, b, dilation=dilation)
    if relu:
        out = torch.relu(out)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _padded_bias(bias, cout_pad: int, device) -> torch.Tensor:
    bk = torch.zeros(cout_pad, dtype=torch.float32, device=device)
    if bias is not None:
        bk[: bias.shape[0]] = bias
    return bk


def _group_width(name: str, cin: int, cout: int, groups: int, chunk: int, cout_tile: int) -> int:
    """Cin / groups, where `groups` gives each group whole K chunks of
    `chunk` input channels and whole Cout tiles of `cout_tile`; else raise."""
    if groups < 1 or cin % groups or (groups > 1 and ((cin // groups) % chunk or cout % (groups * cout_tile))):
        raise ValueError(f"{name}: groups {groups} must give each group whole {chunk}-channel K chunks of Cin {cin} "
                         f"and whole {cout_tile}-channel tiles of Cout {cout}")
    return cin // groups


def _check_packed(name: str, x, tensors) -> None:
    """Each (tensor, what, shape, dtype) contiguous, of that shape and dtype, on x's device."""
    for t, what, shape, dtype in tensors:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} {what} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def launch_pipelined(x, wk, bk, cout: int, kh: int, kw: int, relu: bool, groups: int = 1,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """conv_pipelined on a CUDA f32 x [B,H,W,Cin] (Cin % 4 == 0, 16-byte
    aligned): wk the kernel [kh, kw, Cin / groups, Cout] as ``pack_pipelined``
    packs it, bk an f32 bias [Cout_pad], padding (k//2, k-1-k//2), optional
    ReLU, then `residual` [B,H,W,Cout] f32 (16-byte aligned) added where given.
    groups > 1 takes whole 8-channel chunks and whole 128-channel Cout tiles
    per group. Returns [B,H,W,Cout] f32. The one launch site of the kernel;
    each caller counts its launch."""
    b, h, w, cin = x.shape
    if x.dtype != torch.float32 or cin % 4 or x.data_ptr() % 16:
        raise ValueError(f"conv_pipelined: expected a 16-byte aligned float32 x, Cin % 4 == 0; got {x.dtype}, Cin {cin}")
    cin_g = _group_width("conv_pipelined", cin, cout, groups, PIPE_CHUNK, PIPE_COT)
    cout_pad = _round_up(cout, PIPE_COT)
    packed = [(wk, "kernel", (_round_up(cin_g, PIPE_CHUNK) // PIPE_CHUNK, kh * kw, PIPE_CHUNK, cout_pad), torch.float32),
              (bk, "bias", (cout_pad,), torch.float32)]
    if residual is not None:
        packed.append((residual, "residual", (b, h, w, cout), torch.float32))
    _check_packed("conv_pipelined", x, packed)
    if residual is not None and residual.data_ptr() % 16:
        raise ValueError(f"conv_pipelined: the residual must be 16-byte aligned; got a view at {residual.data_ptr():#x}")
    stream = _kernels.stream(x)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "conv_pipelined_f32", x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(), b, h, w, cin, cout, cout_pad, kh, kw,
        int(relu), groups, stream,
    )
    return out


def wgmma_tiles(cin: int, cout: int, groups: int = 1) -> tuple[int, int]:
    """conv_wgmma's (Cout tile, K chunk) for a call: ``pack_wgmma``'s, the
    tile of Cout and the chunk of one group's Cin."""
    return cout_tile(cout), wgmma_chunk(cin // groups)


def wgmma_plan(cin: int, cout: int, kh: int, kw: int, dilation: int = 1, groups: int = 1) -> dict:
    """The plan conv_wgmma launches for a call (``launch_wgmma``'s tiles):
    its Cout tile, K chunk, dynamic shared memory, halo stages and B ring
    depth (0: the weights stay resident). Builds the kernels; raises where
    the kernel does not take the call."""
    import ctypes

    n_t, ck = wgmma_tiles(cin, cout, groups)
    plan = (ctypes.c_int * 3)()
    args = (cin, _round_up(cout, n_t), kh, kw, dilation, n_t, ck, groups, ctypes.addressof(plan))
    if _kernels.query("conv_wgmma_plan", *args):
        raise ValueError(f"conv_wgmma has no plan for Cin {cin}, Cout {cout}, {kh}x{kw}, dilation {dilation}, "
                         f"groups {groups}")
    return {"n_tile": n_t, "chunk": ck, "smem": plan[0], "halo_stages": plan[1], "ring": plan[2]}


def launch_wgmma(x, wk, bk, cout: int, kh: int, kw: int, dil: int, pad_t: int, pad_l: int, relu: bool,
                 groups: int = 1, out_dtype: torch.dtype = torch.bfloat16,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """conv_wgmma on a CUDA bf16 x [B,H,W,Cin] (Cin % 8 == 0, 16-byte
    aligned): wk the kernel [kh, kw, Cin / groups, Cout] as ``pack_wgmma``
    packs it, bk an f32 bias [Cout_pad], dilation `dil`, low padding pad_t,
    pad_l (the high padding is what the output's size leaves), optional
    ReLU, then `residual` [B,H,W,Cout] bf16 (16-byte aligned, Cout a
    multiple of 8; bf16 output only) added in f32 where given. groups > 1 takes whole K
    chunks and whole Cout tiles per group. Returns [B,H,W,Cout] in
    `out_dtype`: bf16 (rounded once), or f32 (the f32 sum plus bias, not
    rounded; K4's z stage). The one launch site of the kernel; each caller
    counts its launch."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_wgmma: out_dtype must be bfloat16 or float32, got {out_dtype}")
    b, h, w, cin = x.shape
    if x.dtype != torch.bfloat16 or cin % 8 or x.data_ptr() % 16:
        raise ValueError(f"conv_wgmma: expected a 16-byte aligned bfloat16 x, Cin % 8 == 0; got {x.dtype}, Cin {cin}")
    n_t, ck = wgmma_tiles(cin, cout, max(groups, 1))  # _group_width refuses groups < 1
    cin_g = _group_width("conv_wgmma", cin, cout, groups, ck, n_t)
    cout_pad = _round_up(cout, n_t)
    shape = (kh * kw, _round_up(cin_g, ck) // ck, cout_pad, ck)
    packed = [(wk, "kernel", shape, torch.bfloat16), (bk, "bias", (cout_pad,), torch.float32)]
    if residual is not None:
        if out_dtype != torch.bfloat16 or cout % 8 or residual.data_ptr() % 16:
            raise ValueError(f"conv_wgmma: a residual takes a bf16 output, Cout % 8 == 0 and a 16-byte aligned "
                             f"tensor; got {out_dtype}, Cout {cout}, a view at {residual.data_ptr():#x}")
        packed.append((residual, "residual", (b, h, w, cout), torch.bfloat16))
    _check_packed("conv_wgmma", x, packed)
    stream = _kernels.stream(x)
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    _kernels.launch(
        "conv_wgmma_bf16", x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(), b, h, w, cin, cout, cout_pad,
        kh, kw, dil, pad_t, pad_l, int(relu), n_t, ck, groups, int(out_dtype == torch.float32), stream,
    )
    return out


def _launch(name: str, x, kernel, bias, relu: bool, pad_top: int, pad_left: int, dilation: int) -> torch.Tensor:
    """The kernel that ``route`` picks, on a CUDA x: the weights packed for
    it (they are small; x is never copied), the bias f32 and zero-padded."""
    stream = _kernels.stream(x)
    b, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    which = route(name, x.dtype, cin, x.data_ptr())
    # wk and bk stay referenced until the launch has been queued.
    if which == "conv_pipelined":
        wk = pack_pipelined(kernel)
        out = launch_pipelined(x, wk, _padded_bias(bias, wk.shape[3], x.device), cout, kh, kw, relu)
    elif which == "conv_narrow":
        wk = pack_narrow(kernel)
        out = launch_narrow(x, wk, _padded_bias(bias, wk.shape[0] * wk.shape[4], x.device), cout, kh, dilation, relu)
    elif which == "conv_wgmma":
        wk = pack_wgmma(kernel)
        out = launch_wgmma(x, wk, _padded_bias(bias, wk.shape[2], x.device), cout, kh, kw, dilation, pad_top,
                           pad_left, relu)
    else:
        co_tile = cout_tile(cout)
        cin_pad = _round_up(cin, CIN_CHUNK)
        cout_pad = _round_up(cout, co_tile)
        wk = F.pad(kernel.to(x.dtype), (0, cout_pad - cout, 0, cin_pad - cin)).contiguous()
        bk = _padded_bias(bias, cout_pad, x.device)
        out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
        _kernels.launch(
            "conv_direct", x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
            cin_pad, cout_pad, kh, kw, dilation, pad_top, pad_left, int(relu), int(x.dtype == torch.bfloat16),
            co_tile, stream,
        )
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[which] += 1
    return out


def _check_small(kernel: torch.Tensor, what: str) -> None:
    kh, kw = kernel.shape[:2]
    if not (1 <= kh <= 3 and 1 <= kw <= 3):
        raise ValueError(f"{what}: kernel sizes must be 1..3, got {kh}x{kw}")


# ---------------------------------------------------------------- K13, K15


def conv2d_pallas_plain(x, kernel, bias=None, relu: bool = False) -> torch.Tensor:
    """Plain version of K13 (and K15)."""
    kh, kw = kernel.shape[:2]
    return _conv_plain(x, kernel, bias, relu, _torch_pad(kh), _torch_pad(kw), 1)


def _conv_same(name: str, x, kernel, bias, relu: bool) -> torch.Tensor:
    _check(x, kernel, bias, name)
    _check_small(kernel, name)
    if x.device.type == "cpu":
        return conv2d_pallas_plain(x, kernel, bias, relu)
    kh, kw = kernel.shape[:2]
    return _launch(name, x, kernel, bias, relu, kh // 2, kw // 2, 1)


def conv2d_pallas(x, kernel, bias=None, relu: bool = False) -> torch.Tensor:
    """K13: stride-1 convolution with torch-parity 'SAME' padding.

    x [B,H,W,Cin] f32 or bf16; kernel [kh,kw,Cin,Cout] (kh, kw <= 3);
    bias [Cout] or None. Returns [B,H,W,Cout] in x.dtype."""
    return _conv_same("conv2d_pallas", x, kernel, bias, relu)


def conv2d_pallas_im2col(x, kernel, bias=None, relu: bool = False) -> torch.Tensor:
    """K15: ``conv2d_pallas`` (same function, scope and kernel)."""
    return _conv_same("conv2d_pallas_im2col", x, kernel, bias, relu)


# ---------------------------------------------------------------- K14


def conv2d_narrow_plain(x, kernel, bias=None, relu: bool = False, dilation: int = 1) -> torch.Tensor:
    """Plain version of K14."""
    r = (kernel.shape[0] // 2) * dilation
    return _conv_plain(x, kernel, bias, relu, (r, r), (r, r), dilation)


def conv2d_narrow(x, kernel, bias=None, relu: bool = False, dilation: int = 1) -> torch.Tensor:
    """K14: stride-1 convolution with a square 3x3 or 5x5 kernel, dilation
    1 or 2, 'SAME' padding (k//2)*dilation on every side.

    x [B,H,W,Cin] f32 or bf16; kernel [k,k,Cin,Cout]; bias [Cout] or None.
    Returns [B,H,W,Cout] in x.dtype."""
    _check(x, kernel, bias, "conv2d_narrow")
    kh, kw = kernel.shape[:2]
    if kh != kw or kh not in (3, 5):
        raise ValueError(f"conv2d_narrow: the kernel must be 3x3 or 5x5, got {kh}x{kw}")
    if dilation not in (1, 2):
        raise ValueError(f"conv2d_narrow: dilation must be 1 or 2, got {dilation}")
    if x.device.type == "cpu":
        return conv2d_narrow_plain(x, kernel, bias, relu, dilation)
    r = (kh // 2) * dilation
    return _launch("conv2d_narrow", x, kernel, bias, relu, r, r, dilation)
