"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so without a card these
tests skip (decided in a fixture). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only the port's
dependencies, without the repository's conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import dataclasses
import math

import pytest
import torch

from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_luma as cl
from retinex_tpu_torch.ops import fused_blocks as fb


@dataclasses.dataclass
class _Frame:
    rgb: torch.Tensor
    lab: torch.Tensor
    luts: torch.Tensor


@pytest.fixture
def cuda_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    rgb = torch.randint(0, 256, (2, 3, 272, 480), dtype=torch.uint8, device="cuda", generator=g)
    lab = cg.lab_fwd_u8_plain(rgb)
    return _Frame(rgb, lab, cg.clahe_tables_plain(lab))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_frame):
    f = cuda_frame
    cg.reset_launches()
    lab = cg.lab_fwd_u8(f.rgb)
    luts = [cg.clahe_tables(f.lab, hist_subsample=s) for s in (1, 2)]
    out = cg.clahe_apply_u8(f.lab, f.luts)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == {
        "lab_fwd_u8": 1, "lab_fwd_f32_nhwc": 0, "lab_fwd_u8_nhwc": 0, "clahe_tables": 2, "clahe_apply_u8": 1,
        "clahe_apply_f32_nhwc": 0, "clahe_apply_u8_nhwc": 0, "clahe_tables_tiles": 0, "clahe_apply_tiles_f32_nhwc": 0,
    }
    for got, want in ((lab, f.lab), (out, cg.clahe_apply_u8_plain(f.lab, f.luts))):
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4
    assert torch.equal(luts[0], f.luts)
    assert torch.equal(luts[1], cg.clahe_tables_plain(f.lab, hist_subsample=2))


@pytest.mark.cuda
def test_nhwc_and_luma_kernels_match_plain_versions(cuda_frame):
    """K8 (both halves) within 1 level of K1/K3's plain versions on under
    1e-4 of the bytes; K2 on a luma plane identical to its plain version;
    K7 within the same bound of its plain version, K7 on NHWC identical to
    K7 on planar, and K9 identical to K7."""
    x = cuda_frame.rgb.permute(0, 2, 3, 1).contiguous()
    cg.reset_launches()
    cl.reset_launches()
    lab = cg.lab_fwd_u8_nhwc(x)
    out = cg.clahe_apply_u8_nhwc(cuda_frame.lab, cuda_frame.luts)
    y = cl._luma_u8(cuda_frame.rgb)
    luts = cg.clahe_tables(y, hist_subsample=2)
    k7 = cl.clahe_luma_apply_u8(cuda_frame.rgb, y, luts)
    k7_nhwc = cl.clahe_luma_apply_u8(x, y, luts)
    k9 = cl.clahe_luma_apply_u8_fused(cuda_frame.rgb, luts)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["lab_fwd_u8_nhwc"] == cg.LAUNCHES["clahe_apply_u8_nhwc"] == cg.LAUNCHES["clahe_tables"] == 1
    assert cl.LAUNCHES == {"clahe_luma_apply_u8": 2, "clahe_luma_apply_u8_fused": 1}
    assert torch.equal(k7_nhwc, k7.permute(0, 2, 3, 1))
    want_out = cg.clahe_apply_u8_nhwc_plain(cuda_frame.lab, cuda_frame.luts)
    for got, want in ((lab, cuda_frame.lab), (out, want_out), (k7, cl.clahe_luma_apply_u8_plain(cuda_frame.rgb, y, luts))):
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4
    assert torch.equal(luts, cg.clahe_tables_plain(y, hist_subsample=2))
    assert torch.equal(k9, k7)


@pytest.fixture
def cuda_f32():
    """The card, with TF32 off so the plain versions' convolutions and
    products run in full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53, 128), (1, 136, 240, 128)])
def test_fam_kernels_match_plain_versions(cuda_f32, shape):
    """K4-K6 and K11 against their plain versions, with the tolerances of
    tests/test_fused_blocks.py (2e-4, 1e-5, 1e-4, 1e-5) and inputs scaled as there;
    a ragged shape (h, w not multiples of the tiles, batch 2) and the
    scale-2 FAM shape of a 1088x1920 frame."""
    g = cuda_f32
    b, h, w, c = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(b, h, w, c, scale=0.3).abs()
    wf = [n(c, c, scale=0.05) for _ in range(4)]
    conv_args = [
        x, (n(c, c, scale=0.05) @ wf[0]).contiguous(), (n(c, c, scale=0.05) @ wf[1]).contiguous(),
        n(3, 3, c, 2 * c, scale=0.05), n(2 * c, scale=0.1),
        torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[2]).contiguous(),
        torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[3]).contiguous(), n(c, scale=0.1),
    ]
    ca_vec = torch.sigmoid(n(b, c // 4)).repeat(1, 4).contiguous()
    sa = torch.sigmoid(n(b, h, w, 4))
    wg = n(c, c, scale=0.05)

    fb.reset_launches()
    got = [
        fb.fam_conv_fused(*conv_args), fb.fam_tail_stats(x, ca_vec), fb.fam_tail_apply_g1(x, ca_vec, sa, wg),
        fb.fam_tail_apply(x, ca_vec, sa),
    ]
    torch.cuda.synchronize()
    assert fb.LAUNCHES == {
        "fam_conv_fused": 1, "fam_tail_stats": 1, "fam_tail_apply_g1": 1, "fam_tail_apply": 1, "dec1_chain": 0,
        "fam_dual_conv3": 0,
    }
    want = [
        fb.fam_conv_fused_plain(*conv_args),
        fb.fam_tail_stats_plain(x, ca_vec),
        fb.fam_tail_apply_g1_plain(x, ca_vec, sa, wg),
        fb.fam_tail_apply_plain(x, ca_vec, sa),
    ]
    for a, e, tol in zip(got, want, (2e-4, 1e-5, 1e-4, 1e-5)):
        assert a.shape == e.shape
        assert float((a - e).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53, 128), (1, 136, 240, 128)])
def test_fam_conv_stages_match_plain_versions(cuda_f32, shape):
    """K4's three kernels, each against its plain version on the same input
    (y and z from the plain stages), and their chain against K4's plain
    version, within K4's 2e-4; weights packed once (pack_fam_conv) or on the
    call; each image of the batch equals the kernels on it alone."""
    g = cuda_f32
    b, h, w, c = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(b, h, w, c, scale=0.3).abs()
    wf = [n(c, c, scale=0.05) for _ in range(4)]
    ka, kb = (n(c, c, scale=0.05) @ wf[0]).contiguous(), (n(c, c, scale=0.05) @ wf[1]).contiguous()
    k1, b1 = n(3, 3, c, 2 * c, scale=0.05), n(2 * c, scale=0.1)
    k32 = torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[2]).contiguous()
    k42 = torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[3]).contiguous()
    bt = n(c, scale=0.1)
    k2 = fb.stack_second_convs(k32, k42)
    p = fb.pack_fam_conv(ka, kb, k1, b1, k32, k42, bt)
    y, z = fb.fam_conv_y_plain(x, k1, b1), fb.fam_conv_z_plain(fb.fam_conv_y_plain(x, k1, b1), k2, bt)
    fb.reset_launches()
    stages = [fb.fam_conv_y(x, p), fb.fam_conv_z(y, p), fb.fam_conv_out(z, x, p)]
    whole = fb.fam_conv_fused(x, ka, kb, k1, b1, k32, k42, bt, packed=p)
    torch.cuda.synchronize()
    assert fb.KERNEL_LAUNCHES == {
        "fam_conv_y": 2, "fam_conv_z": 2, "fam_conv_out": 2, "fam_tail_apply_g1_diag": 0, "fam_tail_apply_g1_dense": 0,
        "dec1_up": 0, "dec1_c1": 0, "dec1_c2": 0, "dec1_rc": 0,
        "fam_dual_y_pipelined": 0, "fam_dual_y_wgmma": 0, "fam_dual_out_pipelined": 0, "fam_dual_out_wgmma": 0,
    }
    assert fb.LAUNCHES["fam_conv_fused"] == 1
    for got, want in zip(stages, (y, z, fb.fam_conv_out_plain(z, x, ka, kb))):
        assert got.shape == want.shape and float((got - want).abs().max()) <= 2e-4
    assert float((whole - fb.fam_conv_fused_plain(x, ka, kb, k1, b1, k32, k42, bt)).abs().max()) <= 2e-4
    assert torch.equal(fb.fam_conv_fused(x, ka, kb, k1, b1, k32, k42, bt), whole)
    for j in range(b):
        alone = fb.fam_conv_fused(x[j : j + 1].contiguous(), ka, kb, k1, b1, k32, k42, bt, packed=p)
        assert torch.equal(alone, whole[j : j + 1])


def _one_bf16_ulp(got, want, atol=2.0**-10, ulps=1):
    """Within `ulps` bf16 ulps (2**-7 relative at most each), or `ulps` x
    `atol` where the output is a small difference of larger terms; as
    tests/test_torch_amp_kernels.py holds the plain versions to JAX."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=ulps * 2.0**-7, atol=ulps * atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53, 128), (1, 135, 240, 128), (1, 540, 960, 128)])
def test_fam_bf16_kernels_match_plain_versions(cuda_f32, shape):
    """The bf16 instances of K4 (whole and its three stages: y on
    conv_wgmma, z on conv_wgmma's f32-output mode, fam_conv_out's bf16
    instance, on the tensor cores), K5, K6 (both w layouts, the quadrant-
    diagonal one on the tensor cores) and K11 against their bf16 plain
    versions on the card: one output ulp where the f32 sums run in another
    order (K4, K6 and its two instances against each other; K5's means),
    K11 bit-identical (its products are exact
    and rounded once each), K4's z within K4's f32 2e-4 and f32. A ragged
    shape, batch 2, and the 1080-row frame's scale-2 and scale-1 shapes;
    each image of the batch equals the kernels on it alone."""
    g = cuda_f32
    b, h, w, c = shape
    bf = torch.bfloat16

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(b, h, w, c, scale=0.3).abs().to(bf)
    wf = [n(c, c, scale=0.05) for _ in range(4)]
    weights = [
        (n(c, c, scale=0.05) @ wf[0]).contiguous(), (n(c, c, scale=0.05) @ wf[1]).contiguous(),
        n(3, 3, c, 2 * c, scale=0.05), n(2 * c, scale=0.1),
        torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[2]).contiguous(),
        torch.einsum("uvio,op->uvip", n(3, 3, c, c, scale=0.05), wf[3]).contiguous(), n(c, scale=0.1),
    ]
    ca_vec = torch.sigmoid(n(b, c // 4)).to(bf).float().repeat(1, 4).contiguous()
    sa = torch.sigmoid(n(b, h, w, 4)).to(bf)
    wg = n(c, c, scale=0.05)
    from retinex_tpu_torch.ops.s2d import pack_pointwise

    wd = torch.as_tensor(pack_pointwise((torch.randn(1, 1, 32, 32, generator=torch.Generator().manual_seed(1)) * 0.1)
                                        .numpy())[0, 0]).cuda()
    p = fb.pack_fam_conv(*weights, dtype=bf)
    k2 = fb.stack_second_convs(weights[4], weights[5])
    y_plain = fb.fam_conv_y_plain(x, weights[2], weights[3])
    z_plain = fb.fam_conv_z_plain(y_plain, k2, weights[6])
    fb.reset_launches()
    y, z, out = fb.fam_conv_y(x, p), fb.fam_conv_z(y_plain, p), fb.fam_conv_out(z_plain, x, p)
    whole = fb.fam_conv_fused(x, *weights, packed=p)
    stats = fb.fam_tail_stats(x, ca_vec)
    g1 = {name: fb.fam_tail_apply_g1(x, ca_vec, sa, wm, fb.pack_tail_g1(wm)) for name, wm in (("diag", wd), ("dense", wg))}
    apply = fb.fam_tail_apply(x, ca_vec, sa)
    torch.cuda.synchronize()
    assert fb.BF16_LAUNCHES == {
        "fam_conv_fused_bf16": 1, "fam_tail_stats_bf16": 1, "fam_tail_apply_g1_bf16": 2, "fam_tail_apply_bf16": 1,
        "fam_conv_y_bf16": 2, "fam_conv_z_bf16": 2, "fam_conv_out_bf16": 2, "fam_tail_apply_g1_diag_bf16": 1,
        "fam_tail_apply_g1_dense_bf16": 1, "dec1_chain_bf16": 0, "dec1_up_bf16": 0, "dec1_c1_bf16": 0,
        "dec1_c2_bf16": 0, "dec1_rc_bf16": 0,
    }
    assert all(v == 0 for v in (*fb.LAUNCHES.values(), *fb.KERNEL_LAUNCHES.values()))
    _one_bf16_ulp(y, y_plain)
    assert z.dtype == torch.float32 and float((z - z_plain).abs().max()) <= 2e-4
    _one_bf16_ulp(out, fb.fam_conv_out_plain(z_plain, x, weights[0], weights[1]))
    # Whole K4 rounds y and then the output: a y rounded the other way
    # moves the output's sum, so two ulps (chip_smoke.AMP_ULPS).
    _one_bf16_ulp(whole, fb.fam_conv_fused_plain(x, *weights), ulps=2)
    _one_bf16_ulp(whole, fb.fam_conv_staged_plain(x, *weights), ulps=2)
    _one_bf16_ulp(stats, fb.fam_tail_stats_plain(x, ca_vec), atol=0)
    for name, wm in (("diag", wd), ("dense", wg)):
        _one_bf16_ulp(g1[name], fb.fam_tail_apply_g1_plain(x, ca_vec, sa, wm))
    # The dense instance (CUDA cores, fmaf) on the diagonal w: the tensor-core
    # instance sums in another order, so one ulp.
    _one_bf16_ulp(fb.fam_tail_apply_g1(x, ca_vec, sa, wd), g1["diag"])
    assert torch.equal(apply, fb.fam_tail_apply_plain(x, ca_vec, sa))
    for j in range(b):
        sl = lambda t: t[j : j + 1].contiguous()  # noqa: E731
        assert torch.equal(fb.fam_conv_fused(sl(x), *weights, packed=p), whole[j : j + 1])
        assert torch.equal(fb.fam_tail_apply_g1(sl(x), sl(ca_vec), sl(sa), wd, fb.pack_tail_g1(wd)), g1["diag"][j : j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 136, 240)])
def test_dec1_chain_matches_plain_version(cuda_f32, shape):
    """K10 against its plain version within tests/test_fused_blocks.py:66's
    1e-4, inputs scaled as there: a ragged shape (the 'SAME' padding of
    every stage at the border, batch 2) and a wider one; each of its four
    conv_pipelined stages against its plain version on the plain previous
    stage's output, within the same 1e-4; packed once (pack_dec1_chain) or
    on the call, the same bits; each image of the batch equals the kernels
    on it alone."""
    g = cuda_f32
    b, h, w = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    d2, x1p = n(b, h, w, 64, scale=0.3), n(b, h, w, 128, scale=0.3).abs()
    weights = [n(1, 1, 64, 128, scale=0.1), n(128, scale=0.1)]
    for _ in range(3):
        weights += [n(3, 3, 128, 128, scale=0.05), n(128, scale=0.1)]
    k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc = weights
    p = fb.pack_dec1_chain(*weights)
    y1 = fb.dec1_up_plain(d2, k_up, b_up)
    y2 = fb.dec1_conv_plain(y1, k_c1, b_c1)
    y3 = fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)
    fb.reset_launches()
    stages = [fb.dec1_up(d2, p), fb.dec1_c1(y1, p), fb.dec1_c2(y2, x1p, p), fb.dec1_rc(y3, p)]
    got = fb.dec1_chain(d2, x1p, *weights, packed=p)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["dec1_chain"] == 1
    assert {k: v for k, v in fb.KERNEL_LAUNCHES.items() if v} == {"dec1_up": 2, "dec1_c1": 2, "dec1_c2": 2, "dec1_rc": 2}
    for out, want in zip(stages, (y1, y2, y3, fb.dec1_conv_plain(y3, k_rc, b_rc))):
        assert out.shape == want.shape and float((out - want).abs().max()) <= 1e-4
    assert float((got - fb.dec1_chain_plain(d2, x1p, *weights)).abs().max()) <= 1e-4
    assert torch.equal(fb.dec1_chain(d2, x1p, *weights), got)
    for j in range(b):
        assert torch.equal(fb.dec1_chain(d2[j : j + 1].contiguous(), x1p[j : j + 1].contiguous(), *weights), got[j : j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 136, 240)])
def test_dec1_chain_bf16_matches_plain_version(cuda_f32, shape):
    """K10 in bf16 (its four stages on conv_wgmma, dec1_c2 with the residual
    epilogue) against its bf16 plain version: each stage on the plain
    previous stage's output within one output ulp (rtol and atol 1e-2, as
    the conv_wgmma tests below), the chain whole within one ulp at its
    largest output (chip_smoke.K10_BF16's note: three intermediate
    roundings, each of which may go the other way and move the later sums
    near 0 by more than their own ulp), inputs scaled as the f32 test; the
    residual epilogue leaves the
    stage without it alone (dec1_c2 minus x1p's add is dec1_c1's function);
    each image of the batch equals the kernels on it alone."""
    g = cuda_f32
    b, h, w = shape
    bf = torch.bfloat16

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    d2, x1p = n(b, h, w, 64, scale=0.3).to(bf), n(b, h, w, 128, scale=0.3).abs().to(bf)
    weights = [n(1, 1, 64, 128, scale=0.1), n(128, scale=0.1)]
    for _ in range(3):
        weights += [n(3, 3, 128, 128, scale=0.05), n(128, scale=0.1)]
    k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc = weights
    p = fb.pack_dec1_chain(*weights, dtype=bf)
    y1 = fb.dec1_up_plain(d2, k_up, b_up)
    y2 = fb.dec1_conv_plain(y1, k_c1, b_c1)
    y3 = fb.dec1_conv_plain(y2, k_c2, b_c2, x1p)
    fb.reset_launches()
    stages = [fb.dec1_up(d2, p), fb.dec1_c1(y1, p), fb.dec1_c2(y2, x1p, p), fb.dec1_rc(y3, p)]
    got = fb.dec1_chain(d2, x1p, *weights, packed=p)
    torch.cuda.synchronize()
    assert {k: v for k, v in fb.BF16_LAUNCHES.items() if v} == {
        "dec1_chain_bf16": 1, "dec1_up_bf16": 2, "dec1_c1_bf16": 2, "dec1_c2_bf16": 2, "dec1_rc_bf16": 2,
    }
    assert all(v == 0 for v in (*fb.LAUNCHES.values(), *fb.KERNEL_LAUNCHES.values()))
    for out, want in zip(stages, (y1, y2, y3, fb.dec1_conv_plain(y3, k_rc, b_rc))):
        assert out.dtype == want.dtype == bf and out.shape == want.shape
        torch.testing.assert_close(out.float(), want.float(), rtol=1e-2, atol=1e-2)
    want = fb.dec1_chain_plain(d2, x1p, *weights)
    ulp = 2.0 ** (int(math.floor(math.log2(float(want.float().abs().max())))) - 7)
    assert got.dtype == want.dtype == bf and float((got.float() - want.float()).abs().max()) <= ulp
    # Without x1p the third stage's launch is the residual-free instance.
    no_res = fb.launch_wgmma(y2, p.c2_packed, b_c2, 128, 3, 3, 1, 1, 1, True)
    assert torch.equal(no_res, fb.launch_wgmma(y2, p.c2_packed, b_c2, 128, 3, 3, 1, 1, 1, True,
                                               residual=torch.zeros_like(x1p)))
    torch.testing.assert_close(no_res.float(), fb.dec1_conv_plain(y2, k_c2, b_c2).float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(fb.dec1_chain(d2, x1p, *weights), got)
    for j in range(b):
        assert torch.equal(fb.dec1_chain(d2[j : j + 1].contiguous(), x1p[j : j + 1].contiguous(), *weights), got[j : j + 1])


def _close(got, want, dtype):
    """f32 within 1e-4; bf16 compared in f32 at rtol and atol 1e-2 (one
    output ulp: both round one f32 sum, summed in other orders)."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    else:
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 48, 64), (2, 37, 53, 24), (2, 37, 53, 256)])
def test_conv_kernels_match_plain_versions(cuda_f32, shape, dtype):
    """K13 (both paddings of an even kernel axis; Cout 128, 64 and 96), K15
    (3x3 to 128, 2x2 to 256) and K14 (dilation 2, and a 5x5 with a Cout
    that is no multiple of 4) against their plain versions, on ragged H and
    W and Cin 24, 64 and 256, inputs N(0,1) and kernels x 0.05 as
    tests/test_conv_pallas.py scales them. bf16 runs on conv_wgmma; in f32
    K13/K15 run on conv_pipelined, K14 on conv_narrow; each image of the
    batch equals the kernel on it alone."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    cin = shape[3]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)

    def k(kh, kw, cout):
        return torch.randn((kh, kw, cin, cout), generator=g, device="cuda") * 0.05

    bias = torch.randn(256, generator=g, device="cuda")
    cases = [
        (cp.conv2d_pallas, cp.conv2d_pallas_plain, (k(3, 2, 128), bias[:128], True), {}),
        (cp.conv2d_pallas, cp.conv2d_pallas_plain, (k(2, 2, 64), None, False), {}),
        (cp.conv2d_pallas, cp.conv2d_pallas_plain, (k(3, 3, 96), bias[:96], True), {}),
        (cp.conv2d_pallas_im2col, cp.conv2d_pallas_plain, (k(3, 3, 128), bias[:128], False), {}),
        (cp.conv2d_pallas_im2col, cp.conv2d_pallas_plain, (k(2, 2, 256), bias, False), {}),
        (cp.conv2d_narrow, cp.conv2d_narrow_plain, (k(3, 3, 64), bias[:64], True), {"dilation": 2}),
        (cp.conv2d_narrow, cp.conv2d_narrow_plain, (k(5, 5, 30), bias[:30], False), {}),
    ]
    if dtype == torch.bfloat16:
        kernels = {"conv_direct": 0, "conv_wgmma": 7, "conv_pipelined": 0, "conv_narrow": 0}
    else:
        kernels = {"conv_direct": 0, "conv_wgmma": 0, "conv_pipelined": 5, "conv_narrow": 2}
    cp.reset_launches()
    got = [fn(x, *args, **kw) for fn, _, args, kw in cases]
    torch.cuda.synchronize()
    assert cp.LAUNCHES == {"conv2d_pallas": 3, "conv2d_pallas_im2col": 2, "conv2d_narrow": 2}
    assert cp.KERNEL_LAUNCHES == kernels
    for out, (_, plain, args, kw) in zip(got, cases):
        _close(out, plain(x, *args, **kw), dtype)
    for j in sorted({0, shape[0] - 1}):
        for out, (fn, _, args, kw) in zip(got, cases):
            assert torch.equal(fn(x[j : j + 1].contiguous(), *args, **kw), out[j : j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [32, 24, 64])
def test_conv_narrow_bf16_runs_on_the_tensor_cores(cuda_f32, cin):
    """K14 in bf16 on conv_wgmma: 3x3 and 5x5 at dilation 1 and 2, Cout 32,
    64, 40 (a padded Cout tile) and 128 (N = 128: the weights go through the
    ring, three B stages beside Cin 64's 24x24 halo at 5x5, dilation 2),
    with and without ReLU, on a ragged [2,37,53] against its plain version
    at rtol and atol 1e-2; Cin 32 and 24 take the 32-channel K chunk, 64 the
    64-channel one; each image of the batch equals the kernel on it alone."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    x = torch.randn((2, 37, 53, cin), generator=g, device="cuda").to(torch.bfloat16)
    couts = ((32, True), (64, False), (40, True), (128, False))
    cases = [(k, dil, cout, relu) for k in (3, 5) for dil in (1, 2) for cout, relu in couts]
    for k, dil, cout, relu in cases:
        kern = torch.randn((k, k, cin, cout), generator=g, device="cuda") * 0.05
        bias = torch.randn(cout, generator=g, device="cuda")
        cp.reset_launches()
        got = cp.conv2d_narrow(x, kern, bias, relu, dilation=dil)
        torch.cuda.synchronize()
        assert cp.KERNEL_LAUNCHES == {"conv_direct": 0, "conv_wgmma": 1, "conv_pipelined": 0, "conv_narrow": 0}
        _close(got, cp.conv2d_narrow_plain(x, kern, bias, relu, dilation=dil), torch.bfloat16)
        for j in range(2):
            alone = cp.conv2d_narrow(x[j : j + 1].contiguous(), kern, bias, relu, dilation=dil)
            assert torch.equal(alone, got[j : j + 1])


@pytest.mark.cuda
def test_conv_wgmma_has_a_plan_for_every_routed_call(cuda_f32):
    """route sends every bf16 call with Cin % 8 == 0 and an aligned x to
    conv_wgmma, whatever its kernel, dilation, Cin and Cout: each of those
    has a shared-memory plan there (K13/K15's 1..3 x 1..3, K14's 3x3 and
    5x5 at dilation 1 and 2)."""
    import ctypes

    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.ops import conv_pallas as cp

    shapes = [(kh, kw, 1) for kh in (1, 2, 3) for kw in (1, 2, 3)] + [(k, k, d) for k in (3, 5) for d in (1, 2)]
    plan = (ctypes.c_int * 3)()
    for kh, kw, dil in shapes:
        for cin in (8, 24, 32, 40, 64, 136, 512):
            for cout in (8, 32, 40, 64, 96, 128, 200, 384):
                n_t = cp.cout_tile(cout)
                args = (cin, -(-cout // n_t) * n_t, kh, kw, dil, n_t, cp.wgmma_chunk(cin), 1, ctypes.addressof(plan))
                assert _kernels.query("conv_wgmma_plan", *args) == 0, (kh, kw, dil, cin, cout)
                assert plan[0] <= 232448 and plan[1] >= 2 and plan[2] in (0, 2, 3, 4)
    # K4's two calls in bf16 (fam_conv_y 128 -> 256, fam_conv_z 256 -> 128),
    # planned as launch_wgmma plans them, and launched at both FAM scales of
    # the letterboxed frame and of the 1080-row frame (544 and 540 packed
    # rows, 136 and 135), the shapes the bf16 packed forward gives them.
    for cin, cout in ((128, 256), (256, 128)):
        assert cp.wgmma_plan(cin, cout, 3, 3)["smem"] <= 232448
    p = fb.pack_fam_conv(*(torch.randn(s, device="cuda") * 0.05 for s in (
        (128, 128), (128, 128), (3, 3, 128, 256), (256,), (3, 3, 128, 128), (3, 3, 128, 128), (128,))),
        dtype=torch.bfloat16)
    for h, w in ((544, 960), (136, 240), (540, 960), (135, 240)):
        x = torch.rand((1, h, w, 128), device="cuda").to(torch.bfloat16)
        y = fb.fam_conv_y(x, p)
        z = fb.fam_conv_z(y, p)
        torch.cuda.synchronize()
        assert y.shape == (1, h, w, 256) and y.dtype == torch.bfloat16
        assert z.shape == (1, h, w, 128) and z.dtype == torch.float32 and bool(torch.isfinite(z).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_misaligned_view_goes_to_conv_direct(cuda_f32, dtype):
    """A contiguous view one element past an aligned base fails TMA's (and
    cp.async's) 16-byte rule, so K13, K15 and K14 take conv_direct, and
    still hold to their plain versions."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    shape = (2, 21, 35, 128)
    flat = torch.randn(1 + torch.Size(shape).numel(), generator=g, device="cuda").to(dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    kern = torch.randn((3, 3, 128, 96), generator=g, device="cuda") * 0.05
    bias = torch.randn(96, generator=g, device="cuda")
    cp.reset_launches()
    got = [
        cp.conv2d_pallas(x, kern, bias, True), cp.conv2d_pallas_im2col(x, kern, bias),
        cp.conv2d_narrow(x, kern, bias, dilation=2),
    ]
    torch.cuda.synchronize()
    assert cp.KERNEL_LAUNCHES == {"conv_direct": 3, "conv_wgmma": 0, "conv_pipelined": 0, "conv_narrow": 0}
    _close(got[0], cp.conv2d_pallas_plain(x, kern, bias, True), dtype)
    _close(got[1], cp.conv2d_pallas_plain(x, kern, bias), dtype)
    _close(got[2], cp.conv2d_narrow_plain(x, kern, bias, dilation=2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 48, 128), (2, 37, 53, 128)])
def test_fam_dual_conv3_matches_plain_version(cuda_f32, shape, dtype):
    """K12 against its plain version (1e-4 in f32 as tests/test_fused_blocks.py:47,
    one ulp in bf16), inputs scaled as there, and each of its two stages
    against its plain version (the second on the plain y): f32 on
    conv_pipelined, bf16 on conv_wgmma, one launch of each stage per call;
    each image equals K12 on it alone; a misaligned x is refused."""
    g = cuda_f32

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(*shape, scale=0.3).to(dtype)
    w = [n(3, 3, 128, 256, scale=0.05), n(256), n(3, 3, 128, 128, scale=0.05), n(128), n(3, 3, 128, 128, scale=0.05), n(128)]
    k2, b2 = fb.stack_dual_convs(*w[2:])
    y = fb.fam_dual_y_plain(x, w[0], w[1])
    fb.reset_launches()
    got = fb.fam_dual_conv3(x, *w)
    stages = [fb.fam_dual_y(x, w[0], w[1]), fb.fam_dual_out(y, k2, b2)]
    torch.cuda.synchronize()
    assert fb.LAUNCHES["fam_dual_conv3"] == 1
    kernel = "pipelined" if dtype == torch.float32 else "wgmma"
    assert {k: v for k, v in fb.KERNEL_LAUNCHES.items() if v} == {f"fam_dual_y_{kernel}": 2, f"fam_dual_out_{kernel}": 2}
    _close(got, fb.fam_dual_conv3_plain(x, *w), dtype)
    _close(stages[0], y, dtype)
    _close(stages[1], fb.fam_dual_out_plain(y, k2, b2), dtype)
    for j in range(shape[0]):
        assert torch.equal(fb.fam_dual_conv3(x[j : j + 1].contiguous(), *w), got[j : j + 1])
    flat = torch.zeros(1 + x.numel(), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fb.fam_dual_conv3(flat[1:].view(x.shape), *w)


def _grouped_plain(x, k, b, groups, relu, residual=None):
    """F.conv2d(groups=...) in f32 on x and the kernel rounded to x.dtype,
    + b, optional ReLU, + residual, one rounding to x.dtype."""
    xc = x.float().permute(0, 3, 1, 2)
    out = torch.nn.functional.conv2d(xc, k.to(x.dtype).float().permute(3, 2, 0, 1), b, padding=k.shape[0] // 2,
                                     groups=groups).permute(0, 2, 3, 1)
    out = torch.relu(out) if relu else out
    return (out if residual is None else out + residual).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53, 256), (1, 136, 240, 256)])
def test_grouped_convolutions_match_grouped_conv2d(cuda_f32, shape):
    """conv_pipelined (f32) and conv_wgmma (bf16) with groups = 2 on Cin 256
    (K12's second stage: 128 input channels a group, Cout 256, one 128-wide
    Cout tile a group) against F.conv2d(groups=2), with and without ReLU, at
    a ragged shape and a wider one: f32 within 1e-4, bf16 one ulp; each
    image of the batch equals the kernel on it alone."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    x32 = torch.randn(shape, generator=g, device="cuda")
    k = torch.randn((3, 3, 128, 256), generator=g, device="cuda") * 0.05
    b = torch.randn(256, generator=g, device="cuda")
    for relu in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            if dtype == torch.float32:
                def run(v):
                    return cp.launch_pipelined(v, cp.pack_pipelined(k), b, 256, 3, 3, relu, groups=2)
            else:
                def run(v):
                    return cp.launch_wgmma(v, cp.pack_wgmma(k), b, 256, 3, 3, 1, 1, 1, relu, groups=2)
            got = run(x)
            torch.cuda.synchronize()
            _close(got, _grouped_plain(x, k, b, 2, relu), dtype)
            for j in range(shape[0]):
                assert torch.equal(run(x[j : j + 1].contiguous()), got[j : j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53, 256), (1, 136, 240, 256)])
def test_residual_epilogue_matches_plain_version(cuda_f32, shape):
    """conv_pipelined's residual epilogue, relu(conv + b) + residual: at Cout
    128 (K10's dec1_c2) and 256, dense and with groups = 2, against the plain
    composition within 1e-4, and bit for bit the same launch without the
    residual plus the residual (the epilogue adds it after the ReLU, once)."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    x = torch.randn(shape, generator=g, device="cuda")
    for cout, groups in ((128, 1), (256, 1), (256, 2)):
        k = torch.randn((3, 3, shape[3] // groups, cout), generator=g, device="cuda") * 0.05
        b = torch.randn(cout, generator=g, device="cuda")
        res = torch.randn((*shape[:3], cout), generator=g, device="cuda").abs()
        wk = cp.pack_pipelined(k)
        got = cp.launch_pipelined(x, wk, b, cout, 3, 3, True, groups=groups, residual=res)
        bare = cp.launch_pipelined(x, wk, b, cout, 3, 3, True, groups=groups)
        torch.cuda.synchronize()
        _close(got, _grouped_plain(x, k, b, groups, True, res), torch.float32)
        assert torch.equal(got, bare + res)


@pytest.mark.cuda
def test_conv_wgmma_plans_k12s_grouped_calls(cuda_f32):
    """conv_wgmma_plan answers for each call K12's bf16 wrappers make
    (fam_dual_y: 128 -> 256; fam_dual_out: 256 -> 256, groups 2) with the
    tiles launch_wgmma passes: a ring of B stages beside the halo stages,
    within the card's shared memory; it refuses what make_args refuses (a
    group of 48 channels, 4 groups of 64 outputs), so it answers for the
    arguments the kernel launches with."""
    import ctypes

    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.ops import conv_pallas as cp

    for cin, groups in ((128, 1), (256, 2)):
        plan = cp.wgmma_plan(cin, 256, 3, 3, 1, groups)
        assert (plan["n_tile"], plan["chunk"]) == cp.wgmma_tiles(cin, 256, groups) == (128, 64)
        assert plan["smem"] <= 232448 and plan["halo_stages"] >= 2 and plan["ring"] in (2, 3, 4)
    out = (ctypes.c_int * 3)()
    for cin, cout, groups, ck in ((96, 256, 2, 64), (256, 256, 4, 64), (256, 256, 3, 64)):
        assert _kernels.query("conv_wgmma_plan", cin, cout, 3, 3, 1, 128, ck, groups, ctypes.addressof(out)) == -1
        with pytest.raises(ValueError, match="groups"):
            cp.wgmma_plan(cin, cout, 3, 3, 1, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [((2, 96, 128, 3), (8, 8)), ((1, 48, 84, 3), (4, 6))])
def test_clahe_pallas_matches_plain_version(cuda_f32, shape, tiles):
    """K16's two kernels against their plain versions: Lab within 1 level on
    under 1e-4 of the bytes, the histograms those of the kernel's own L, the
    output within 1 level of the plain pipeline's on under 1e-4 of the values."""
    from retinex_tpu_torch.ops import clahe_pallas as kp

    ty, tx = tiles
    x = torch.rand(shape, generator=cuda_f32, device="cuda")
    kp.reset_launches()
    lab, hist = kp.clahe_pallas_hist(x, ty, tx)
    out = kp.clahe_lab_rgb_pallas(x, tiles_x=tx, tiles_y=ty)
    torch.cuda.synchronize()
    assert kp.LAUNCHES == {"clahe_pallas_hist": 2, "clahe_pallas_apply": 1}
    lab_p, _ = kp.clahe_pallas_hist_plain(x, ty, tx)
    d = (lab.int() - lab_p.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4
    assert torch.equal(hist, kp.l_histograms(lab, ty, tx))
    _, h, w, _ = shape
    luts = kp._luts(hist, 2.0, h, w, ty, tx)
    got = kp.clahe_pallas_apply(lab, luts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kp.clahe_pallas_apply_plain(lab, luts), rtol=0, atol=1.01 / 255)
    e = ((out - kp.clahe_lab_rgb_pallas_plain(x, tiles_x=tx, tiles_y=ty)) * 255).abs()
    assert float(e.max()) <= 1.01 and float((e > 0.5).float().mean()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 136, 240)])
def test_fam_tail_apply_g1_instances_match_plain_version(cuda_f32, shape):
    """K6's two instances, at a ragged pixel count on a batch of 2 and at
    the scale-2 FAM shape of a 1088x1920 frame: the quadrant-diagonal one
    (a pack_pointwise w, the main path's) and the dense one at Cout 128 and
    12, each within K6's 1e-4 of the plain version; on the same block-
    diagonal w the two instances give the same bits; each image of a batch
    equals the kernel on it alone."""
    g = cuda_f32
    b, h, w = shape
    x = (torch.randn(b, h, w, 128, generator=g, device="cuda") * 0.4).abs()
    ca = torch.sigmoid(torch.randn(b, 32, generator=g, device="cuda")).repeat(1, 4).contiguous()
    sa = torch.sigmoid(torch.randn(b, h, w, 4, generator=g, device="cuda"))
    block = torch.randn(32, 32, generator=g, device="cuda") * 0.1
    wd = torch.block_diag(block, block, block, block).contiguous()
    dense = torch.randn(128, 128, generator=g, device="cuda") * 0.05
    pd = fb.pack_tail_g1(wd)
    assert pd.diag and not fb.pack_tail_g1(dense).diag
    fb.reset_launches()
    got_diag = fb.fam_tail_apply_g1(x, ca, sa, wd, packed=pd)
    got_as_dense = fb.fam_tail_apply_g1(x, ca, sa, wd)  # unpacked: the dense instance
    got_dense = {c: fb.fam_tail_apply_g1(x, ca, sa, dense[:, :c].contiguous()) for c in (128, 12)}
    torch.cuda.synchronize()
    assert fb.KERNEL_LAUNCHES["fam_tail_apply_g1_diag"] == 1
    assert fb.KERNEL_LAUNCHES["fam_tail_apply_g1_dense"] == 3
    assert float((got_diag - fb.fam_tail_apply_g1_plain(x, ca, sa, wd)).abs().max()) <= 1e-4
    assert torch.equal(got_diag, got_as_dense)
    for c, got in got_dense.items():
        want = fb.fam_tail_apply_g1_plain(x, ca, sa, dense[:, :c].contiguous())
        assert got.shape == want.shape == (b, h, w, c)
        assert float((got - want).abs().max()) <= 1e-4
    for j in range(b):
        one = [t[j : j + 1].contiguous() for t in (x, ca, sa)]
        assert torch.equal(fb.fam_tail_apply_g1(*one, wd, packed=pd), got_diag[j : j + 1])
        assert torch.equal(fb.fam_tail_apply_g1(*one, dense[:, :12].contiguous()), got_dense[12][j : j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("tiles", [4, 8, 16])
def test_clahe_tables_match_plain_version(cuda_f32, tiles, batch):
    """K2 at 4, 8 and 16 tiles a side, hist_subsample 1 and 2, on the L
    plane of planar Lab and on a luma plane, of noise and of a smooth
    random walk (flat tiles, clipped histograms): identical to the plain
    version; each image of a batch identical to K2 on it alone."""
    g = cuda_f32
    noise = torch.randint(0, 256, (batch, 3, 256, 480), dtype=torch.uint8, device="cuda", generator=g)
    steps = torch.randint(-3, 4, (batch, 3, 256, 480), device="cuda", generator=g)
    walk = torch.clamp(steps.cumsum(dim=-1) + 128, 0, 255).to(torch.uint8)
    cg.reset_launches()
    n = 0
    for rgb in (noise, walk):
        for plane in (cg.lab_fwd_u8_plain(rgb), cl._luma_u8(rgb)):
            for s in (1, 2):
                got = cg.clahe_tables(plane, tiles_y=tiles, tiles_x=tiles, hist_subsample=s)
                n += 1
                assert torch.equal(got, cg.clahe_tables_plain(plane, tiles_y=tiles, tiles_x=tiles, hist_subsample=s))
                for j in sorted({0, batch - 1}):
                    alone = cg.clahe_tables(plane[j : j + 1].contiguous(), tiles_y=tiles, tiles_x=tiles, hist_subsample=s)
                    n += 1
                    assert torch.equal(alone, got[j : j + 1])
    torch.cuda.synchronize()
    assert cg.LAUNCHES["clahe_tables"] == n


def _cube():
    """Planar [1, 3, 4096, 4096] u8: every (first, second, third) byte triple once."""
    v = torch.arange(256**3, device="cuda", dtype=torch.int32)
    return torch.stack([v >> 16, (v >> 8) & 255, v & 255]).to(torch.uint8).reshape(1, 3, 4096, 4096)


def _within_one_level(got, want):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4


@pytest.mark.cuda
def test_lab_fwd_over_every_srgb_triple(cuda_f32):
    """K1 in its u8 instance and its float one (reading the cube / 255
    stored channels first, as the nets' outputs are, and NHWC) within 1
    level of the plain versions on under 1e-4 of the bytes over the whole
    sRGB cube; the float instance's bytes equal the u8 instance's."""
    cube = _cube()
    lab = cg.lab_fwd_u8(cube)
    _within_one_level(lab, cg.lab_fwd_u8_plain(cube))
    x = (cube.float() / 255.0).permute(0, 2, 3, 1)
    for xx in (x, x.contiguous()):
        got = cg.lab_fwd_f32_nhwc(xx)
        _within_one_level(got, cg.lab_fwd_f32_nhwc_plain(xx))
        assert torch.equal(got, lab)


@pytest.mark.cuda
def test_lab_fwd_equals_the_cpus_plain_version_over_every_srgb_triple(cuda_f32):
    """K1's float instance (the stage every Lab-CLAHE route on the card
    starts with) gives the CPU's plain Lab bytes for every sRGB triple: its
    cube roots are cbrtf's, rounded to nearest where a byte lies near a
    rounding tie."""
    x = (_cube().cpu().float() / 255.0).permute(0, 2, 3, 1)
    want = cg.lab_fwd_f32_nhwc_plain(x)
    got = cg.lab_fwd_f32_nhwc(x.cuda()).cpu()
    assert torch.equal(got, want), f"{int((got != want).sum())} Lab bytes differ from the CPU's"


@pytest.mark.cuda
def test_f4_record_plain_lab_to_rgb_over_every_lab_triple(cuda_f32):
    """F4's record: the plain lab_u8_to_rgb (the plain route's Lab -> sRGB
    half, which no route of clahe_lab_rgb runs on the card) rounded to
    bytes, card against CPU, over every (L, a, b) triple. The count of
    differing bytes is printed, not bounded."""
    from retinex_tpu_torch.ops.colorspace import lab_u8_to_rgb

    v = torch.arange(256**3, dtype=torch.int32)
    lab = torch.stack([v >> 16, (v >> 8) & 255, v & 255], dim=-1).float().reshape(4096, 4096, 3)
    card = torch.round(lab_u8_to_rgb(lab.cuda()) * 255.0).to(torch.uint8).cpu()
    cpu = torch.round(lab_u8_to_rgb(lab) * 255.0).to(torch.uint8)
    n = int((card != cpu).sum())
    print(f"F4: {n} of {cpu.numel()} bytes differ between the card's and the CPU's lab_u8_to_rgb")
    assert card.shape == cpu.shape


def _route_frame(name):
    """A frame of the Lab-CLAHE route gate, float NHWC [1, h, w, 3] on the CPU."""
    import numpy as np
    from PIL import Image

    if name == "uniform":
        g = torch.Generator().manual_seed(12)
        x = torch.rand((1, 1080, 1920, 3), generator=g)
        x.view(-1)[::89] = (torch.randint(0, 255, (x.view(-1)[::89].numel(),), generator=g).float() + 0.5) / 255.0
        return x
    h, w = name
    with Image.open("data/convergence/lowlight_000.png") as im:
        a = np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR), dtype=np.float32) / 255.0
    return torch.from_numpy(a)[None]


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [(1080, 1920), (264, 480), (1001, 1503), "uniform"])
def test_clahe_lab_rgb_on_the_card_equals_the_cpu(cuda_f32, frame):
    """F4 repaired (G1): clahe_lab_rgb on the card gives the CPU's values on
    the headline photo at 1080x1920, the small flagless frame, a frame
    padded on both sides, and a uniform frame with exact .5 ties; on the
    card a frame that is not cell-divisible runs K1's float instance and K2
    and K3 in their tile modes, once each, and nothing else counted."""
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    x = _route_frame(frame)
    cg.reset_launches()
    card = clahe_lab_rgb(x.cuda()).cpu()
    assert {k: v for k, v in cg.LAUNCHES.items() if v} == {
        "lab_fwd_f32_nhwc": 1, "clahe_tables_tiles": 1, "clahe_apply_tiles_f32_nhwc": 1,
    }
    cpu = clahe_lab_rgb(x)
    assert torch.equal(card, cpu), f"{int((card != cpu).sum())} values differ"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1080, 1920), (2, 57, 41), (1, 1001, 1503), (1, 270, 480)])
def test_tile_modes_match_plain_versions(cuda_f32, shape):
    """K2's tile-row mode identical to its plain version; K3's
    tile-coordinate mode within 1 level of its plain version on under 1e-4
    of the bytes; each launched once a call."""
    b, h, w = shape
    rgb = torch.randint(0, 256, (b, 3, h, w), dtype=torch.uint8, device="cuda", generator=cuda_f32)
    lab = cg.lab_fwd_u8_plain(rgb)
    cg.reset_launches()
    luts = cg.clahe_tables_tiles(lab)
    out = cg.clahe_apply_tiles_f32_nhwc(lab, luts)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["clahe_tables_tiles"] == cg.LAUNCHES["clahe_apply_tiles_f32_nhwc"] == 1
    assert torch.equal(luts, cg.clahe_tables_tiles_plain(lab))
    want = cg.clahe_apply_tiles_f32_nhwc_plain(lab, luts)
    _within_one_level(torch.round(out * 255.0).to(torch.uint8), torch.round(want * 255.0).to(torch.uint8))


def _levels_apart(got, want) -> str:
    """How far two byte tensors are apart, for a test's printed record."""
    d = (got.int() - want.int()).abs()
    return f"max {int(d.max())} level(s) on {int((d > 0).sum())} of {d.numel()} bytes"


@pytest.mark.cuda
def test_clahe_pallas_hist_over_every_srgb_triple(cuda_f32):
    """K16's first kernel over the whole sRGB cube, the input each byte /
    255 NHWC: Lab equal to the plain version's on the card, and within 1
    level of the plain version's on the CPU on under 1e-4 of the bytes; the
    histograms those of the kernel's own L."""
    from retinex_tpu_torch.ops import clahe_pallas as kp

    x = (_cube().float() / 255.0).permute(0, 2, 3, 1).contiguous()
    lab, hist = kp.clahe_pallas_hist(x)
    assert torch.equal(hist, kp.l_histograms(lab, 8, 8))
    card = kp.clahe_pallas_hist_plain(x)[0]
    cpu = kp.clahe_pallas_hist_plain(x.cpu())[0]
    print(f"K16 Lab over the sRGB cube: against the card's plain version {_levels_apart(lab, card)}; "
          f"against the CPU's {_levels_apart(lab.cpu(), cpu)}")
    assert torch.equal(lab, card)
    _within_one_level(lab.cpu(), cpu)


@pytest.mark.cuda
def test_clahe_pallas_apply_over_every_lab_triple(cuda_f32):
    """K16's second kernel over the whole (L, a, b) cube with identity LUTs
    at 8x8 tiles (the blend keeps L): within 1 level of the plain version on
    under 1e-4 of the bytes, on the card and on the CPU."""
    from retinex_tpu_torch.ops import clahe_pallas as kp

    cube = _cube()
    luts = torch.arange(256, device="cuda", dtype=torch.uint8).expand(1, 8, 8, 256).contiguous()
    got = torch.round(kp.clahe_pallas_apply(cube, luts) * 255.0).to(torch.uint8)
    card = torch.round(kp.clahe_pallas_apply_plain(cube, luts) * 255.0).to(torch.uint8)
    cpu = torch.round(kp.clahe_pallas_apply_plain(cube.cpu(), luts.cpu()) * 255.0).to(torch.uint8)
    print(f"K16 apply over the Lab cube: against the card's plain version {_levels_apart(got, card)}; "
          f"against the CPU's {_levels_apart(got.cpu(), cpu)}")
    _within_one_level(got, card)
    _within_one_level(got.cpu(), cpu)


@pytest.mark.cuda
def test_clahe_apply_over_every_lab_triple(cuda_f32):
    """K3 in its u8 instance and its float one over the whole (L, a, b)
    cube with identity LUTs at 8x8 tiles (the blend keeps L): within 1
    level of the plain versions on under 1e-4 of the bytes; the float
    instance is the u8 instance / 255 (IEEE division), NHWC."""
    cube = _cube()
    luts = torch.arange(256, device="cuda", dtype=torch.uint8).expand(1, 8, 8, 256).contiguous()
    out = cg.clahe_apply_u8(cube, luts)
    _within_one_level(out, cg.clahe_apply_u8_plain(cube, luts))
    out_f = cg.clahe_apply_f32_nhwc(cube, luts)
    assert torch.equal(out_f, cg.dequantise_nhwc(out))
    want_f = cg.clahe_apply_f32_nhwc_plain(cube, luts)
    _within_one_level(torch.round(out_f * 255.0).to(torch.uint8), torch.round(want_f * 255.0).to(torch.uint8))


@pytest.mark.cuda
def test_float_route_equals_u8_route_and_glue(cuda_f32):
    """clahe_lab_rgb_gather (the float instances of K1 and K3) bit for bit
    equal to the u8 planar route between the plain quantisation and the
    IEEE division by 255, on a seeded 1088x1920 frame stored channels first with
    values past [0, 1] and exact .5 ties; one call launches K1's and K3's
    float instances and K2 once each and nothing else counted."""
    base = torch.rand((1, 3, 1088, 1920), device="cuda", generator=cuda_f32) * 1.2 - 0.1
    base.view(-1)[::89] = (torch.randint(0, 255, (base.view(-1)[::89].numel(),), device="cuda", generator=cuda_f32) + 0.5) / 255.0
    x = base.permute(0, 2, 3, 1)
    cg.reset_launches()
    got = cg.clahe_lab_rgb_gather(x)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == {
        "lab_fwd_u8": 0, "lab_fwd_f32_nhwc": 1, "lab_fwd_u8_nhwc": 0, "clahe_tables": 1, "clahe_apply_u8": 0,
        "clahe_apply_f32_nhwc": 1, "clahe_apply_u8_nhwc": 0, "clahe_tables_tiles": 0, "clahe_apply_tiles_f32_nhwc": 0,
    }
    want = cg.dequantise_nhwc(cg.clahe_rgb_u8_planar_gather(cg.quantise_planar_u8(x)))
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(cg.clahe_lab_rgb_gather(x.contiguous()), got)


@pytest.mark.cuda
def test_ieee_div_equals_the_cpus_division_on_the_card(cuda_f32):
    """ieee_div on the card gives the CPU's IEEE f32 quotient (PyTorch on
    CUDA divides by a Python number as a product by its reciprocal): every
    integer in [-70000, 70000) and 4M random floats of several magnitudes,
    over the divisors the port's byte and Lab arithmetic uses."""
    from retinex_tpu_torch.ops.colorspace import ieee_div

    ints = torch.arange(-70000, 70000, dtype=torch.float32)
    rand = torch.rand(1 << 22, generator=torch.Generator().manual_seed(0)) * torch.logspace(-6, 6, 1 << 22)
    for v in (ints, rand):
        for c in (255.0, 12.92, 1.055, 0.950456, 1.088754, 116.0, 7.787, 500.0, 200.0):
            got = ieee_div(v.cuda(), c).cpu()
            assert torch.equal(got, v / c), (c, int((got != v / c).sum()))
    assert int((ints.cuda() / 255.0).cpu().ne(ints / 255.0).sum()) > 0  # the product the helper avoids


@pytest.mark.cuda
def test_plain_lab_route_and_gray_over_every_srgb_triple(cuda_f32):
    """F3: the plain Lab-CLAHE route's quantisation and Lab bytes (K1's
    plain float version, which clahe_lab_rgb runs on every frame that is
    not cell-divisible) and the gray levels of brightness_features and of
    the saliency map are the same on the card as on the CPU over every
    sRGB triple, the input each byte / 255 (IEEE, so the quantisation
    gives the byte back), stored NHWC and channels first."""
    from retinex_tpu_torch.infer.adaptive_params import gray_levels

    cube = _cube().cpu()
    x = (cube.float() / 255.0).permute(0, 2, 3, 1)
    want_lab = cg.lab_fwd_f32_nhwc_plain(x)
    want_gray = gray_levels(x)
    assert torch.equal(cg.quantise_planar_u8(x), cube)
    for xc in (x.cuda(), x.contiguous().cuda()):
        lab = cg.lab_fwd_f32_nhwc_plain(xc).cpu()
        assert torch.equal(lab, want_lab), f"{int((lab != want_lab).sum())} Lab bytes differ from the CPU's"
        gray = gray_levels(xc).cpu()
        assert torch.equal(gray, want_gray), f"{int((gray != want_gray).sum())} gray levels differ from the CPU's"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,cout,dil,relu", [
    ((2, 1088, 1920, 32), 3, 32, 1, True), ((2, 1088, 1920, 32), 3, 64, 1, True),
    ((2, 1088, 1920, 32), 3, 32, 2, False), ((2, 37, 53, 24), 5, 40, 1, True),
    ((2, 37, 53, 24), 3, 30, 2, False), ((2, 37, 53, 64), 5, 128, 2, True),
    ((2, 1088, 1920, 32), 5, 32, 1, True),
    ((1, 19, 70, 20), 5, 200, 1, False), ((3, 8, 9, 4), 3, 7, 2, True),
])
def test_conv_narrow_f32_runs_on_its_kernel(cuda_f32, shape, k, cout, dil, relu):
    """K14 in f32 on conv_narrow: the seven shapes chip_smoke.py's phase 17
    drives ([2,1088,1920,32] and the ragged ones: 3x3 and 5x5,
    dilation 1 and 2, Cout tiles of 32, 64 and 128), a Cin with a
    zero-filled last chunk and two Cout tiles, and frames smaller than one
    tile, within 1e-4 of the plain version; each image of the batch equals
    the kernel on it alone."""
    from retinex_tpu_torch.ops import conv_pallas as cp

    g = cuda_f32
    x = torch.randn(shape, generator=g, device="cuda")
    kern = torch.randn((k, k, shape[3], cout), generator=g, device="cuda") * 0.05
    bias = torch.randn(cout, generator=g, device="cuda")
    cp.reset_launches()
    got = cp.conv2d_narrow(x, kern, bias, relu, dilation=dil)
    torch.cuda.synchronize()
    assert cp.KERNEL_LAUNCHES == {"conv_direct": 0, "conv_wgmma": 0, "conv_pipelined": 0, "conv_narrow": 1}
    _close(got, cp.conv2d_narrow_plain(x, kern, bias, relu, dilation=dil), torch.float32)
    for j in sorted({0, shape[0] - 1}):
        assert torch.equal(cp.conv2d_narrow(x[j : j + 1].contiguous(), kern, bias, relu, dilation=dil), got[j : j + 1])


def _luma_frames(g):
    """u8 NHWC batches for K7 and K9: noise, flat frames (one value per
    image: 0, 255, 91) and a photo (data/convergence/lowlight_000.png),
    each with 8x8 tiles; and a noise frame whose width is no multiple of 8
    (6 tiles a side), which takes the kernels' one-pixel path."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    photo = Path(__file__).resolve().parent.parent / "data" / "convergence" / "lowlight_000.png"
    with Image.open(photo) as im:
        img = torch.from_numpy(np.asarray(im.convert("RGB"))).cuda()[None]
    flat = torch.tensor([0, 255, 91], dtype=torch.uint8, device="cuda").view(3, 1, 1, 1).expand(3, 272, 480, 3)
    return [
        (torch.randint(0, 256, (2, 272, 480, 3), dtype=torch.uint8, device="cuda", generator=g), 8),
        (flat.contiguous(), 8),
        (img.contiguous(), 8),
        (torch.randint(0, 256, (2, 120, 252, 3), dtype=torch.uint8, device="cuda", generator=g), 6),
    ]


@pytest.mark.cuda
def test_luma_kernels_bit_identical_to_plain_versions(cuda_f32):
    """K7 (planar and NHWC) and K9 equal their plain versions byte for byte
    on noise, flat frames and a photo, at hist_subsample 1 and 2, and on a
    width that takes their one-pixel path."""
    for x, tiles in _luma_frames(cuda_f32):
        xp = x.permute(0, 3, 1, 2).contiguous()
        y = cl._luma_u8(xp)
        for s in (1, 2):
            luts = cg.clahe_tables(y, tiles_y=tiles, tiles_x=tiles, hist_subsample=s)
            cl.reset_launches()
            k7 = cl.clahe_luma_apply_u8(xp, y, luts)
            k7_nhwc = cl.clahe_luma_apply_u8(x, y, luts)
            k9 = cl.clahe_luma_apply_u8_fused(xp, luts)
            torch.cuda.synchronize()
            assert cl.LAUNCHES == {"clahe_luma_apply_u8": 2, "clahe_luma_apply_u8_fused": 1}
            want = cl.clahe_luma_apply_u8_plain(xp, y, luts)
            assert torch.equal(k7, want), (tuple(x.shape), s, int((k7 != want).sum()))
            assert torch.equal(k7_nhwc, cl.clahe_luma_apply_u8_plain(x, y, luts)), (tuple(x.shape), s)
            assert torch.equal(k9, cl.clahe_luma_apply_u8_fused_plain(xp, luts)), (tuple(x.shape), s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,h,w,once", [
    ("clahe", 64, 96, {"lab_fwd_f32_nhwc": 1, "clahe_tables": 1, "clahe_apply_f32_nhwc": 1}),
    ("clahe", 72, 104, {"lab_fwd_f32_nhwc": 1, "clahe_tables_tiles": 1, "clahe_apply_tiles_f32_nhwc": 1}),
    ("clahe_luma", 64, 96, {"clahe_tables": 1, "clahe_luma_apply_u8": 1}),
])
def test_serving_artifact_launches_the_kernels(cuda_f32, mode, h, w, once):
    """A classical artifact exported on the card (infer/serving.py) calls the
    kernels' operators: each served call launches them once, on batches of 1
    and 3 from one artifact, with the eager pipeline's bytes (the tile modes
    at 72x104, which is not cell-divisible)."""
    from retinex_tpu_torch.infer import serving
    from retinex_tpu_torch.infer.enhance import make_batch_pipeline

    served = serving.load_enhancer(serving.export_classical(mode, h, w, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(5)
    for b in (1, 3):
        x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=g)
        cg.reset_launches()
        cl.reset_launches()
        got = served(x)
        torch.cuda.synchronize()
        counts = {k: v for m in (cg, cl) for k, v in m.LAUNCHES.items() if v}
        assert counts == once, counts
        assert torch.equal(got, make_batch_pipeline(None, mode)(x)[0])
