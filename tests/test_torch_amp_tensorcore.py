"""The tensor-core bf16 instances of K4's last stage (``fam_conv_out``) and
K6 (``fam_tail_apply_g1``, quadrant-diagonal w), on the CPU.

Their kernels (``fam_conv_out_mma_kernel``, ``fam_tail_apply_g1_mma_kernel``
in ``retinex_tpu_torch/csrc/fam_fused.cu``) run only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold them to their plain
versions. Here:

- the weight layouts they read: K6's w split into three bf16 pieces that
  sum to it exactly (compared in f64), for the packed model's fusion folds
  and for seeded dense and wide-range w; the pieces and K4's [ka; kb] in
  the kernels' B layout (columns in ``mma_channels`` order, transposed)
  unpack exactly to the blocks' pieces and to [ka; kb] in bf16;
- the kernels' arithmetic, emulated: K6's scaled bf16 x against the three
  pieces, and K4's [x | maxpool(x)] against the packed B added to z, each
  product exact in f32 and summed in f32, rounded once, within one bf16
  ulp of the plain versions and (K6) of the JAX package's Pallas kernel in
  interpret mode; K4's max pool walked as the kernel walks its halo tile
  equals ``maxpool3x3_s1_s2d``;
- the wrappers take the plain versions for CPU tensors and count no launch,
  and refuse a bf16 quadrant-diagonal pack without its pieces.

Inputs come from numpy seeds, scaled as tests/test_torch_amp_kernels.py
scales them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.ops import fused_blocks as tfb
from retinex_tpu_torch.ops.s2d import maxpool3x3_s1_s2d, pack_pointwise

BF16 = torch.bfloat16
C, Q = 128, 32


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _within_one_ulp(got, want):
    """One bf16 ulp (2**-7 relative at most), or 2**-10 where the output is
    a small difference of larger terms (tests/test_torch_amp_kernels.py)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(jnp.asarray(got).astype(jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-10)


def _diag_w(seed: int) -> torch.Tensor:
    """pack_pointwise of a seeded [1,1,32,32] 1x1: the main path's K6 w."""
    return _t(pack_pointwise(np.random.default_rng(seed).standard_normal((1, 1, Q, Q)) * 0.1)[0, 0])


def _tail_inputs(rng, b, h, w):
    """x and sa rounded to bf16, ca_vec of bf16 values in f32."""
    x = _t(np.abs(rng.standard_normal((b, h, w, C))) * 0.4, BF16)
    ca_vec = _t(np.tile(1.0 / (1.0 + np.exp(-rng.standard_normal((b, Q)))), 4), BF16).float()
    sa = _t(1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, w, 4)))), BF16)
    return x, ca_vec, sa


def _k4_weights(rng):
    """K4's seven f32 weights, scaled as the f32 tests scale them."""
    wf = [rng.standard_normal((C, C)) * 0.05 for _ in range(4)]
    args = [
        rng.standard_normal((C, C)) * 0.05 @ wf[0], rng.standard_normal((C, C)) * 0.05 @ wf[1],
        rng.standard_normal((3, 3, C, 2 * C)) * 0.05, rng.standard_normal((2 * C,)) * 0.1,
        np.einsum("uvio,op->uvip", rng.standard_normal((3, 3, C, C)) * 0.05, wf[2]),
        np.einsum("uvio,op->uvip", rng.standard_normal((3, 3, C, C)) * 0.05, wf[3]),
        rng.standard_normal((C,)) * 0.1,
    ]
    return [_t(a) for a in args]


@pytest.fixture(scope="module")
def model_folds():
    from retinex_tpu_torch.cli import init_untrained
    from retinex_tpu_torch.models.packed_inference import PackedRetinex
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    packed = PackedRetinex(init_untrained(MultiScaleUPRetinex(False, False), seed=0).eval())
    return {"fold_f1": packed.fold_f1, "fold_f2": packed.fold_f2}


def test_mma_channels_puts_a_lanes_pairs_on_eight_consecutive_channels():
    """A permutation, its own inverse; lane t's pairs of the four n8 tiles
    (columns 8s + 2t + e of a block of 32) are channels 8t.. 8t + 7 in the
    order 2s + e, the order its 16-byte chunk holds them."""
    for width in (Q, C):
        perm = tfb.mma_channels(width)
        assert sorted(perm.tolist()) == list(range(width))
        assert torch.equal(perm[perm], torch.arange(width))
    perm = tfb.mma_channels(C)
    for blk in range(4):
        for t in range(4):
            cols = [32 * blk + 8 * s + 2 * t + e for s in range(4) for e in range(2)]
            assert perm[cols].tolist() == list(range(32 * blk + 8 * t, 32 * blk + 8 * t + 8))


@pytest.mark.parametrize("case", ["fold_f1", "fold_f2", "dense", "wide_range"])
def test_split_bf16x3_sums_exactly_to_w(model_folds, case):
    """The three pieces are bf16 and sum to w exactly (in f64): the packed
    model's two fusion folds (the quadrant-diagonal instance's w), a seeded
    dense w and one whose entries span 2**-100 to 2**100 with all 24
    significand bits set at random."""
    rng = np.random.default_rng(21)
    if case in model_folds:
        w = model_folds[case].w
    elif case == "dense":
        w = _t(rng.standard_normal((C, C)) * 0.05)
    else:
        mant = 1.0 + rng.integers(0, 2**23, (C, C)) / 2**23
        w = _t(np.ldexp(mant * rng.choice([-1.0, 1.0], (C, C)), rng.integers(-100, 100, (C, C))))
    pieces = tfb.split_bf16x3(w)
    assert pieces.dtype == BF16 and pieces.shape == (3, *w.shape)
    assert torch.equal(pieces.double().sum(0), w.double())
    assert torch.equal(pieces[0], w.to(BF16))
    assert bool(pieces[1].ne(0).any())  # the f32 w carries bits past bf16


def test_k6_mma_w_unpacks_to_the_blocks_pieces(model_folds):
    """``mma_w`` of a quadrant-diagonal pack: for each quadrant and piece,
    transposed and its columns put back in channel order, the piece of that
    diagonal block; the three sum to the block exactly. A dense pack's is
    the dense instance's B image instead (tests/test_torch_k6_dense_wgmma.py)."""
    perm = tfb.mma_channels(Q)
    for w in (model_folds["fold_f1"].w, _diag_w(3)):
        p = tfb.pack_tail_g1(w)
        assert p.diag and p.mma_w.shape == (3, 4, Q, Q) and p.mma_w.dtype == BF16 and p.mma_w.is_contiguous()
        for q in range(4):
            block = w[Q * q : Q * q + Q, Q * q : Q * q + Q]
            unpacked = p.mma_w[:, q].transpose(-1, -2)[..., perm]  # [3, k, n]
            assert torch.equal(unpacked, tfb.split_bf16x3(block))
            assert torch.equal(unpacked.double().sum(0), block.double())
    dense = _t(np.random.default_rng(4).standard_normal((C, C)))
    assert torch.equal(tfb.pack_tail_g1(dense).mma_w, tfb.tail_g1_wgmma_b(dense))


def test_fam_conv_out_b_layout_unpacks_to_ka_kb():
    """The bf16 pack's [ka; kb] is the tensor-core kernel's B: [128, 256]
    bf16, which transposed and put back in channel order is [ka; kb] in
    bf16 exactly. The f32 pack keeps [ka; kb] [256, 128] as it was."""
    weights = _k4_weights(np.random.default_rng(7))
    ka, kb = weights[:2]
    p = tfb.pack_fam_conv(*weights, dtype=BF16)
    assert p.kab_packed.shape == (C, 2 * C) and p.kab_packed.dtype == BF16 and p.kab_packed.is_contiguous()
    assert torch.equal(p.kab_packed.t()[:, tfb.mma_channels(C)], torch.cat([ka, kb]).to(BF16))
    assert torch.equal(tfb.pack_fam_conv(*weights).kab_packed, torch.cat([ka, kb]))


def _k6_emulated(x, ca_vec, sa, p: tfb.TailG1Packed):
    """K6's tensor-core arithmetic: the scaled bf16 x (x * ca rounded, * sa
    rounded) of each quadrant against the three bf16 pieces of ``mma_w``,
    each product exact in f32, the pieces' sums added in f32, the MMA's
    columns put back in channel order, rounded to bf16 once."""
    xs = tfb.fam_tail_apply_plain(x, ca_vec, sa).float()
    perm = tfb.mma_channels(Q)
    out = []
    for q in range(4):
        xq = xs[..., Q * q : Q * q + Q]
        acc = sum(xq @ p.mma_w[i, q].float().t() for i in range(3))  # [..., MMA column]
        out.append(acc[..., perm])
    return torch.cat(out, dim=-1).to(BF16)


@pytest.mark.parametrize("b,h,w", [(1, 8, 64), (2, 8, 64), (2, 37, 53)])
def test_k6_tensor_core_arithmetic_within_one_ulp(b, h, w):
    """The emulated arithmetic within one bf16 ulp of the plain version; at
    tests/test_torch_amp_kernels.py's shapes also of the JAX package's
    Pallas kernel (interpret mode) on the same numpy inputs."""
    x, ca_vec, sa = _tail_inputs(np.random.default_rng(6), b, h, w)
    wd = _diag_w(8)
    got = _k6_emulated(x, ca_vec, sa, tfb.pack_tail_g1(wd))
    assert got.dtype == BF16 and got.shape == (b, h, w, C)
    _within_one_ulp(got, tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, wd))
    if h == 8:
        want = jfb.fam_tail_apply_g1(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(ca_vec.numpy()),
            jnp.asarray(sa.float().numpy()).astype(jnp.bfloat16), jnp.asarray(wd.numpy()), interpret=True,
        )
        _within_one_ulp(got, want)


def _pool_as_the_kernel_walks(x: torch.Tensor) -> torch.Tensor:
    """fam_conv_out_mma_kernel's max pool, by its own index arithmetic: 8 x 16
    tiles of packed pixels with a zero halo of one; in each, original row R
    (relative to the tile's first) is halo row (R + 2) // 2, quadrant row R
    & 1; the 3-wide max along original rows 4 prow - 1 .. 4 prow + 4, then
    the 3-high max down them, per packed column and 8-channel chunk."""
    b, h, w, _ = x.shape
    th, tw = 8, 16
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    xp = torch.zeros(b, hp + 2, wp + 2, C, dtype=x.dtype)
    xp[:, 1 : h + 1, 1 : w + 1] = x
    out = torch.empty(b, hp, wp, C, dtype=x.dtype)
    pj = torch.arange(tw)
    for r0 in range(0, hp, th):
        for c0 in range(0, wp, tw):
            halo = xp[:, r0 : r0 + th + 2, c0 : c0 + tw + 2].reshape(b, th + 2, tw + 2, 4, Q)
            for prow in range(th // 2):
                hm = []
                for i in range(6):
                    big_r = 4 * prow - 1 + i
                    row = halo[:, (big_r + 2) >> 1]  # [b, 18, 4 quadrants, 32]
                    qa = big_r & 1
                    l0, l1 = row[:, pj, 2 * qa + 1], row[:, pj + 1, 2 * qa]
                    l2, l3 = row[:, pj + 1, 2 * qa + 1], row[:, pj + 2, 2 * qa]
                    hm.append((torch.maximum(torch.maximum(l0, l1), l2), torch.maximum(torch.maximum(l1, l2), l3)))
                    if i >= 2:
                        orow = r0 + 2 * prow + ((i - 2) >> 1)
                        for bq in range(2):
                            v = torch.maximum(torch.maximum(hm[i - 2][bq], hm[i - 1][bq]), hm[i][bq])
                            quad = 2 * (i & 1) + bq
                            out[:, orow, c0 : c0 + tw, Q * quad : Q * quad + Q] = v
    return out[:, :h, :w]


@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 10, 20), (2, 5, 37)])
def test_fam_conv_out_pool_walk_equals_maxpool(shape):
    """The kernel's walk over its halo tile gives maxpool3x3_s1_s2d on a
    post-ReLU x (the zero halo standing in for -inf), at whole tiles and at
    ragged edges."""
    b, h, w = shape
    x = _t(np.abs(np.random.default_rng(9).standard_normal((b, h, w, C))), BF16)
    assert torch.equal(_pool_as_the_kernel_walks(x), maxpool3x3_s1_s2d(x))


@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 6, 10), (1, 13, 37)])
def test_fam_conv_out_tensor_core_arithmetic_within_one_ulp(shape):
    """fam_conv_out_mma_kernel's arithmetic, emulated: the accumulators start
    at z (in the MMA's column order), take [x | maxpool(x)] against the
    packed B (products exact in f32, summed in f32), then the ReLU, the
    channels put back in order, rounded to bf16 once: within one bf16 ulp
    of the plain version, on z from the bf16 plain stages before it."""
    b, h, w = shape
    rng = np.random.default_rng(11)
    weights = _k4_weights(rng)
    x = _t(np.abs(rng.standard_normal((b, h, w, C))) * 0.3, BF16)
    p = tfb.pack_fam_conv(*weights, dtype=BF16)
    y = tfb.fam_conv_y_plain(x, weights[2], weights[3])
    z = tfb.fam_conv_z_plain(y, tfb.stack_second_convs(weights[4], weights[5]), weights[6])
    perm = tfb.mma_channels(C)
    a = torch.cat([x.float(), _pool_as_the_kernel_walks(x).float()], dim=-1)
    acc = z[..., perm] + a @ p.kab_packed.float().t()
    got = torch.relu(acc)[..., perm].to(BF16)
    _within_one_ulp(got, tfb.fam_conv_out_plain(z, x, weights[0], weights[1]))


def test_bf16_wrappers_take_the_plain_versions_on_the_cpu():
    """fam_conv_out with the bf16 pack and fam_tail_apply_g1 with a
    quadrant-diagonal bf16 pack (mma_w) compute their plain versions on CPU
    tensors and count no launch."""
    rng = np.random.default_rng(13)
    weights = _k4_weights(rng)
    x, ca_vec, sa = _tail_inputs(rng, 2, 5, 9)
    z = _t(rng.standard_normal((2, 5, 9, C)))
    tfb.reset_launches()
    p = tfb.pack_fam_conv(*weights, dtype=BF16)
    torch.testing.assert_close(tfb.fam_conv_out(z, x, p), tfb.fam_conv_out_plain(z, x, *weights[:2]), rtol=0, atol=0)
    wd = _diag_w(14)
    got = tfb.fam_tail_apply_g1(x, ca_vec, sa, wd, tfb.pack_tail_g1(wd))
    torch.testing.assert_close(got, tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, wd), rtol=0, atol=0)
    assert all(n == 0 for n in (*tfb.LAUNCHES.values(), *tfb.KERNEL_LAUNCHES.values(), *tfb.BF16_LAUNCHES.values()))


@pytest.mark.parametrize("case", ["no pieces", "f32 pieces", "dense-shaped pieces"])
def test_bf16_diagonal_pack_without_its_pieces_is_refused(case):
    """The bf16 quadrant-diagonal instance reads ``mma_w``: a pack without
    it, or of another dtype or shape, is refused before any launch (f32
    calls read ``kernel_w`` and take it)."""
    wd = _diag_w(15)
    good = tfb.pack_tail_g1(wd)
    mma_w = {"no pieces": None, "f32 pieces": good.mma_w.float(), "dense-shaped pieces": good.mma_w[:, :, :, :16]}[case]
    bad = tfb.TailG1Packed(wd, good.kernel_w, True, None if mma_w is None else mma_w.contiguous())
    x, ca_vec, sa = _tail_inputs(np.random.default_rng(16), 1, 2, 3)
    with pytest.raises(ValueError, match="packed"):
        tfb.fam_tail_apply_g1(x, ca_vec, sa, wd, packed=bad)
    f32 = tfb.fam_tail_apply_g1(x.float(), ca_vec, sa.float(), wd, packed=bad)
    torch.testing.assert_close(f32, tfb.fam_tail_apply_g1_plain(x.float(), ca_vec, sa.float(), wd), rtol=0, atol=0)
