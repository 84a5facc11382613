"""The port's convolutions (K13-K15) against the JAX package's Pallas ones.

``retinex_tpu_torch/ops/conv_pallas.py``'s wrappers get CPU tensors, so
their plain versions run; the JAX side is ``retinex_tpu/ops/conv_pallas.py``
in interpret mode, as its own tests run it, on the same numpy inputs
(x ~ N(0,1), kernels x 0.05, as tests/test_conv_pallas.py scales them).

Tolerances: f32 within atol 1e-4, as tests/test_conv_pallas.py holds the
Pallas kernels to XLA's convolution (the two sum in other orders). bf16 is
compared in f32 at rtol 1e-2 and atol 1e-2: both sides round the same f32
sum once to bf16, so a summation order that moves that sum across a
rounding boundary flips one output ulp (2**-8 relative, under 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import conv_pallas as jcp
from retinex_tpu_torch.ops import conv_pallas as tcp

F32_ATOL = 1e-4
BF16_TOL = 1e-2


def _inputs(seed, shape, kh, kw, cout, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32)
    k = (rng.standard_normal((kh, kw, shape[3], cout)) * 0.05).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32) if bias else None
    return x, k, b


def _run(jax_fn, torch_fn, x, k, b, dtype, **kw):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_fn(jnp.asarray(x, jdt), jnp.asarray(k), None if b is None else jnp.asarray(b), interpret=True, **kw)
    got = torch_fn(torch.from_numpy(x).to(dtype), torch.from_numpy(k), None if b is None else torch.from_numpy(b), **kw)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _assert_close(got, want, dtype):
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize(
    "kh,kw,relu,bias,dtype",
    [
        (3, 3, True, True, torch.float32),
        (2, 2, False, True, torch.float32),
        (3, 2, True, True, torch.float32),
        (3, 3, False, False, torch.float32),
        (3, 2, True, True, torch.bfloat16),
    ],
)
def test_conv2d_pallas_plain_matches_pallas(kh, kw, relu, bias, dtype):
    """K13, including the (3, 2) kernel whose axes pad differently: H by
    (1, 1), W by (1, 0)."""
    x, k, b = _inputs(0, (1, 8, 128, 128), kh, kw, 128, bias)
    tcp.reset_launches()
    got, want = _run(jcp.conv2d_pallas, tcp.conv2d_pallas, x, k, b, dtype, relu=relu)
    _assert_close(got, want, dtype)
    assert tcp.LAUNCHES["conv2d_pallas"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("kh,relu", [(3, True), (2, False)])
def test_conv2d_pallas_im2col_plain_matches_pallas(kh, relu):
    x, k, b = _inputs(3, (1, 8, 128, 128), kh, kh, 128)
    got, want = _run(jcp.conv2d_pallas_im2col, tcp.conv2d_pallas_im2col, x, k, b, torch.float32, relu=relu)
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize(
    "cin,cout,dil,relu,dtype",
    [
        (32, 32, 1, True, torch.float32),
        (32, 64, 2, False, torch.float32),
        (24, 32, 1, True, torch.float32),
        (32, 64, 2, True, torch.bfloat16),
    ],
)
def test_conv2d_narrow_plain_matches_pallas(cin, cout, dil, relu, dtype):
    x, k, b = _inputs(2, (1, 16, 128, cin), 3, 3, cout)
    got, want = _run(jcp.conv2d_narrow, tcp.conv2d_narrow, x, k, b, dtype, relu=relu, dilation=dil)
    _assert_close(got, want, dtype)


def test_plain_versions_on_a_ragged_shape():
    """Shapes the TPU gates refuse (odd H and W, Cin 20, Cout 12, batch 2)
    against PyTorch's own convolution with the same padding."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 7, 11, 20), np.float32))
    b = torch.from_numpy(rng.standard_normal((12,)).astype(np.float32))
    for kh, kw in ((3, 2), (1, 3), (2, 1)):
        k = torch.from_numpy((rng.standard_normal((kh, kw, 20, 12)) * 0.05).astype(np.float32))
        pad = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
        want = torch.nn.functional.conv2d(torch.nn.functional.pad(x.permute(0, 3, 1, 2), pad), k.permute(3, 2, 0, 1), b)
        torch.testing.assert_close(tcp.conv2d_pallas(x, k, b), want.permute(0, 2, 3, 1), rtol=0, atol=F32_ATOL)
    k5 = torch.from_numpy((rng.standard_normal((5, 5, 20, 12)) * 0.05).astype(np.float32))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k5.permute(3, 2, 0, 1), None, padding=4, dilation=2)
    torch.testing.assert_close(tcp.conv2d_narrow(x, k5, dilation=2), want.permute(0, 2, 3, 1), rtol=0, atol=F32_ATOL)


def test_wrappers_raise_outside_their_scope():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="1..3"):
        tcp.conv2d_pallas(x, torch.zeros(4, 4, 8, 8))
    with pytest.raises(ValueError, match="1..3"):
        tcp.conv2d_pallas_im2col(x, torch.zeros(3, 5, 8, 8))
    with pytest.raises(ValueError, match="3x3 or 5x5"):
        tcp.conv2d_narrow(x, torch.zeros(3, 5, 8, 8))
    with pytest.raises(ValueError, match="3x3 or 5x5"):
        tcp.conv2d_narrow(x, torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError, match="dilation"):
        tcp.conv2d_narrow(x, torch.zeros(3, 3, 8, 8), dilation=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcp.conv2d_pallas(x.double(), torch.zeros(3, 3, 8, 8))
    with pytest.raises(ValueError, match="kernel"):
        tcp.conv2d_pallas(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="bias"):
        tcp.conv2d_pallas(x, torch.zeros(3, 3, 8, 8), torch.zeros(4))
    with pytest.raises(ValueError, match="contiguous"):
        tcp.conv2d_pallas(torch.zeros(1, 4, 8, 4).permute(0, 1, 3, 2), torch.zeros(3, 3, 8, 8))
    # Off the CPU a wrapper goes to its kernel, which takes CUDA tensors
    # only: it never falls back to the plain version.
    tcp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tcp.conv2d_narrow(x.to("meta"), torch.zeros(3, 3, 8, 8, device="meta"))
    for dtype in _DTYPES:  # the calls that would go to conv_wgmma and conv_pipelined (or conv_narrow)
        for fn in (tcp.conv2d_pallas, tcp.conv2d_pallas_im2col):
            with pytest.raises(ValueError, match="CUDA"):
                fn(x.to("meta", dtype), torch.zeros(3, 3, 8, 8, device="meta"))
    assert tcp.LAUNCHES == {"conv2d_pallas": 0, "conv2d_pallas_im2col": 0, "conv2d_narrow": 0}
    assert tcp.KERNEL_LAUNCHES == {"conv_direct": 0, "conv_wgmma": 0, "conv_pipelined": 0, "conv_narrow": 0}


# ---------------------------------------------------------------- packing and routing

_DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(128, 128), (256, 256), (96, 96), (24, 24), (32, 64), (40, 30)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (2, 2), (3, 2), (5, 5)])
def test_weight_packers_round_trip_to_hwio(kh, kw, cin, cout):
    """conv_wgmma's [tap, chunk, Cout_pad, CK] bf16 (CK 32 where Cin <= 32,
    else 64) and conv_pipelined's [chunk, tap, 8, Cout_pad] f32 layouts hold
    the HWIO kernel (rounded to the kernel's type) at its place and zeros in
    the padding."""
    rng = np.random.default_rng(kh * 10 + kw)
    k = torch.from_numpy(rng.standard_normal((kh, kw, cin, cout)).astype(np.float32))

    wg = tcp.pack_wgmma(k)
    n = tcp.cout_tile(cout)
    ck = tcp.wgmma_chunk(cin)
    assert ck == (32 if cin <= 32 else 64)
    assert wg.dtype == torch.bfloat16 and wg.is_contiguous()
    assert tuple(wg.shape) == (kh * kw, -(-cin // ck), -(-cout // n) * n, ck)
    assert n == (32 if cout <= 32 else 64 if cout <= 64 else 128)
    hwio = wg.transpose(2, 3).reshape(kh, kw, wg.shape[1] * ck, wg.shape[2])
    assert torch.equal(hwio[:, :, :cin, :cout], k.to(torch.bfloat16))
    assert not hwio[:, :, cin:].any() and not hwio[:, :, :, cout:].any()
    # One (tap, chunk) B tile is N rows of CK input channels (K-major).
    t, c = kh * kw - 1, wg.shape[1] - 1
    assert torch.equal(wg[t, c, :cout, : min(ck, cin - ck * c)], k[kh - 1, kw - 1, ck * c : cin].T.to(torch.bfloat16))

    pp = tcp.pack_pipelined(k)
    assert pp.dtype == torch.float32 and pp.is_contiguous()
    assert tuple(pp.shape) == (-(-cin // 8), kh * kw, 8, -(-cout // 128) * 128)
    hwio = pp.transpose(0, 1).reshape(kh, kw, pp.shape[0] * 8, pp.shape[3])
    assert torch.equal(hwio[:, :, :cin, :cout], k)
    assert not hwio[:, :, cin:].any() and not hwio[:, :, :, cout:].any()


@pytest.mark.parametrize("cout", [30, 32, 40, 64, 128, 200])
@pytest.mark.parametrize("cin", [24, 32, 64, 20])
@pytest.mark.parametrize("k", [3, 5])
def test_narrow_packer_round_trips_to_hwio(k, cin, cout):
    """conv_narrow's [Cout tile, chunk, tap, 8, cot] f32 layout (cot 32, 64
    or 128, the smallest that holds Cout) holds the HWIO kernel at its place
    and zeros in the padding, each (Cout tile, chunk) run contiguous."""
    rng = np.random.default_rng(k * 1000 + cin * 7 + cout)
    w = torch.from_numpy(rng.standard_normal((k, k, cin, cout)).astype(np.float32))
    cot = tcp.cout_tile(cout)
    assert cot == (32 if cout <= 32 else 64 if cout <= 64 else 128)
    pn = tcp.pack_narrow(w)
    n_co, n_ch = -(-cout // cot), -(-cin // 8)
    assert pn.dtype == torch.float32 and pn.is_contiguous()
    assert tuple(pn.shape) == (n_co, n_ch, k * k, 8, cot)
    hwio = pn.permute(2, 1, 3, 0, 4).reshape(k, k, n_ch * 8, n_co * cot)
    assert torch.equal(hwio[:, :, :cin, :cout], w)
    assert not hwio[:, :, cin:].any() and not hwio[:, :, :, cout:].any()
    # One run: Cout tile t, chunk c, tap (u, v), channel j at [t, c, u*k + v, j].
    t, c, u, v = n_co - 1, n_ch - 1, k - 1, k // 2
    co = slice(cot * t, min(cout, cot * (t + 1)))
    assert torch.equal(pn[t, c, u * k + v, : cin - 8 * c, : co.stop - co.start], w[u, v, 8 * c :, co])


@pytest.mark.parametrize(
    "name,dtype,cin,offset,want",
    [
        ("conv2d_pallas", torch.bfloat16, 128, 0, "conv_wgmma"),
        ("conv2d_pallas_im2col", torch.bfloat16, 24, 0, "conv_wgmma"),
        ("conv2d_pallas", torch.bfloat16, 20, 0, "conv_direct"),  # Cin % 8 != 0: no TMA stride
        ("conv2d_pallas_im2col", torch.bfloat16, 128, 8, "conv_direct"),  # a misaligned view
        ("conv2d_pallas", torch.float32, 128, 0, "conv_pipelined"),
        ("conv2d_pallas_im2col", torch.float32, 20, 0, "conv_pipelined"),
        ("conv2d_pallas", torch.float32, 6, 0, "conv_direct"),  # Cin % 4 != 0: no 16-byte copies
        ("conv2d_pallas", torch.float32, 128, 4, "conv_direct"),
        ("conv2d_narrow", torch.bfloat16, 32, 0, "conv_wgmma"),  # K14 in bf16 on the tensor cores
        ("conv2d_narrow", torch.bfloat16, 32, 8, "conv_direct"),  # a misaligned view
        ("conv2d_narrow", torch.bfloat16, 20, 0, "conv_direct"),  # Cin % 8 != 0
        ("conv2d_narrow", torch.float32, 32, 0, "conv_narrow"),  # f32 K14 on its own narrow-tile kernel
        ("conv2d_narrow", torch.float32, 24, 0, "conv_narrow"),
        ("conv2d_narrow", torch.float32, 20, 0, "conv_narrow"),  # Cin % 8 != 0: the last chunk zero-filled
        ("conv2d_narrow", torch.float32, 6, 0, "conv_direct"),  # Cin % 4 != 0: no 16-byte copies
        ("conv2d_narrow", torch.float32, 32, 4, "conv_direct"),  # a misaligned view
    ],
)
def test_route_sends_each_call_to_its_documented_kernel(name, dtype, cin, offset, want):
    assert tcp.route(name, dtype, cin, 1 << 20 | offset) == want
    assert want in tcp.KERNEL_LAUNCHES


# ---------------------------------------------------------------- launch sites: groups and residual


def _pipelined_call(cin, cout, groups, residual_shape=None, residual_dtype=torch.float32):
    x = torch.zeros(1, 5, 7, cin)
    wk = tcp.pack_pipelined(torch.zeros(3, 3, cin // max(groups, 1), cout))
    bk = torch.zeros(wk.shape[3])
    res = None if residual_shape is None else torch.zeros(residual_shape, dtype=residual_dtype)
    return lambda: tcp.launch_pipelined(x, wk, bk, cout, 3, 3, True, groups=groups, residual=res)


def _narrow_call(cin, cout, k, wk_cout=None, bias_len=None, dtype=torch.float32):
    x = torch.zeros(1, 5, 7, cin, dtype=dtype)
    wk = tcp.pack_narrow(torch.zeros(k, k, cin, cout if wk_cout is None else wk_cout))
    bk = torch.zeros(wk.shape[0] * wk.shape[4] if bias_len is None else bias_len)
    return lambda: tcp.launch_narrow(x, wk, bk, cout, k, 1, True)


def _wgmma_call(cin, cout, groups):
    x = torch.zeros(1, 5, 7, cin, dtype=torch.bfloat16)
    wk = tcp.pack_wgmma(torch.zeros(3, 3, cin // max(groups, 1), cout))
    bk = torch.zeros(wk.shape[2])
    return lambda: tcp.launch_wgmma(x, wk, bk, cout, 3, 3, 1, 1, 1, False, groups=groups)


@pytest.mark.parametrize(
    "call,match",
    [
        (_pipelined_call(256, 256, 3), "groups 3"),  # Cin 256 does not split in 3
        (_pipelined_call(24, 256, 2), "groups 2"),  # 12 channels a group: no whole 8-channel chunks
        (_pipelined_call(256, 128, 2), "groups 2"),  # 64 outputs a group: no whole 128-channel Cout tile
        (_pipelined_call(256, 256, 0), "groups 0"),
        (_pipelined_call(128, 128, 1, (1, 5, 6, 128)), "residual"),  # the wrong shape
        (_pipelined_call(128, 128, 1, (1, 5, 7, 128), torch.bfloat16), "residual"),  # the wrong dtype
        (_wgmma_call(96, 256, 2), "groups 2"),  # 48 channels a group: no whole 64-channel K chunk
        (_wgmma_call(256, 256, 4), "groups 4"),  # 64 outputs a group: no whole 128-channel Cout tile
        (_wgmma_call(256, 256, 3), "groups 3"),
        # Calls the kernels take: the checks pass, and a CPU tensor reaches the
        # stream lookup, which takes CUDA tensors only.
        (_pipelined_call(256, 256, 2), "CUDA"),
        (_pipelined_call(128, 128, 1, (1, 5, 7, 128)), "CUDA"),
        (_pipelined_call(64, 128, 1), "CUDA"),
        (_wgmma_call(256, 256, 2), "CUDA"),
        (_wgmma_call(64, 256, 2), "CUDA"),  # 32 channels a group: the 32-channel K chunk
        (_narrow_call(32, 32, 3, wk_cout=64), "kernel"),  # packed for a 64-wide Cout tile
        (_narrow_call(32, 40, 5, bias_len=40), "bias"),  # the bias not padded to the tile
        (_narrow_call(6, 32, 3), "Cin % 4"),
        (_narrow_call(32, 32, 3, dtype=torch.bfloat16), "float32"),
        (_narrow_call(32, 32, 3), "CUDA"),
        (_narrow_call(24, 200, 5), "CUDA"),  # two Cout tiles of 128
    ],
)
def test_launch_sites_check_groups_and_residual(call, match):
    """launch_pipelined and launch_wgmma refuse a `groups` that does not give
    each group whole K chunks and whole Cout tiles, and a residual of the
    wrong shape or dtype, and launch_narrow weights packed for another tile,
    before anything reaches a kernel."""
    tcp.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert tcp.KERNEL_LAUNCHES == {"conv_direct": 0, "conv_wgmma": 0, "conv_pipelined": 0, "conv_narrow": 0}


@pytest.mark.parametrize("cin,cout,groups", [(256, 256, 2), (64, 256, 2), (512, 512, 4), (128, 128, 1)])
def test_grouped_kernels_pack_per_group(cin, cout, groups):
    """A grouped HWIO kernel [kh, kw, Cin / groups, Cout] packs as a dense
    one of Cin / groups input channels: each Cout tile (conv_wgmma's
    wgmma_tiles, conv_pipelined's 128) holds only its own group's weights,
    and the K chunk is chosen by the group's width."""
    rng = np.random.default_rng(cin + groups)
    k = torch.from_numpy(rng.standard_normal((3, 3, cin // groups, cout)).astype(np.float32))
    n_t, ck = tcp.wgmma_tiles(cin, cout, groups)
    assert (n_t, ck) == (tcp.cout_tile(cout), tcp.wgmma_chunk(cin // groups))
    assert (cout // groups) % n_t == 0 and (cin // groups) % ck == 0
    wg = tcp.pack_wgmma(k)
    assert tuple(wg.shape) == (9, cin // groups // ck, cout, ck)
    pp = tcp.pack_pipelined(k)
    assert tuple(pp.shape) == (cin // groups // 8, 9, 8, cout)
    for g in range(groups):
        co = slice(g * cout // groups, (g + 1) * cout // groups)
        want = k[..., co]
        got_wg = wg[:, :, co].transpose(2, 3).reshape(3, 3, cin // groups, cout // groups)
        assert torch.equal(got_wg, want.to(torch.bfloat16))
        got_pp = pp[..., co].transpose(0, 1).reshape(3, 3, cin // groups, cout // groups)
        assert torch.equal(got_pp, want)
