"""The bf16 instances of K4, K5, K6 and K11: their plain versions against the
JAX package's Pallas kernels run on bf16 inputs in interpret mode.

Inputs are drawn from a numpy seed as ``tests/test_torch_fused_blocks.py``
draws them and rounded to bf16 (x, and sa for K6/K11; ca and the weights
stay f32, as the JAX kernels take them). Both sides round at the same
points (``retinex_tpu_torch/ops/fused_blocks.py``):

- K5 and K11 are bit-identical: their products are bf16 x bf16, exact in
  f32, rounded once each, and K5's 32-channel f32 means and maxima are
  rounded to bf16;
- K4 (whole, and staged: y rounded to bf16, z left f32) and K6 (both of
  its w layouts) sum f32 products in another order than the TPU kernel's
  dots, so a sum that lies next to a rounding boundary of the bf16 output
  may round the other way: one output ulp, at most 2**-7 relative (rtol
  2**-7). Where the output is a small difference of larger terms (K4's
  sums of ~1000 products of magnitude ~0.1), a y value that rounded the
  other way moves it by more than its own ulp: atol 2**-10, one ulp at
  the terms' magnitude of 1/8 (seen: 2**-10 at outputs near 0.005, and
  one ulp, 2**-7, at 1.05).

K4's z is held to be f32 and unrounded. The wrappers on the CPU take these
plain versions and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.ops import fused_blocks as tfb
from retinex_tpu_torch.ops.s2d import pack_pointwise

BF16 = torch.bfloat16
ULP = 2.0**-7  # one bf16 ulp, relative, at most


def _bf16(a) -> np.ndarray:
    """f32 numpy values rounded to bf16 (and back to f32 numpy)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


def _conv_inputs(rng, shape):
    """K4's x (rounded to bf16) and f32 weights, scaled as the f32 tests."""
    b, h, w, cin = shape
    x = _bf16(np.abs(rng.standard_normal(shape)) * 0.3)
    w1, w2 = (rng.standard_normal((cin, cin)) * 0.05 for _ in range(2))
    k1 = rng.standard_normal((3, 3, cin, 256)) * 0.05
    b1 = rng.standard_normal((256,)) * 0.1
    k32, k42 = (rng.standard_normal((3, 3, cin, cin)) * 0.05 for _ in range(2))
    wf = [rng.standard_normal((cin, cin)) * 0.05 for _ in range(4)]
    bf = rng.standard_normal((cin,)) * 0.1
    args = [x, w1 @ wf[0], w2 @ wf[1], k1, b1,
            np.einsum("uvio,op->uvip", k32, wf[2]), np.einsum("uvio,op->uvip", k42, wf[3]), bf]
    return [np.asarray(a, np.float32) for a in args]


def _tail_inputs(rng, b, h, w):
    """x and sa rounded to bf16, ca_vec of bf16 values in f32 (the net's
    ca is bf16), a dense f32 w and a quadrant-diagonal one."""
    x = _bf16(np.abs(rng.standard_normal((b, h, w, 128))) * 0.4)
    ca_vec = _bf16(np.tile(1.0 / (1.0 + np.exp(-rng.standard_normal((b, 32)))), 4))
    sa = _bf16(1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, w, 4)))))
    wg = (rng.standard_normal((128, 128)) * 0.05).astype(np.float32)
    wd = pack_pointwise(rng.standard_normal((1, 1, 32, 32)) * 0.1)[0, 0]
    return x, ca_vec, sa, wg, wd


def _within_one_ulp(got, want):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=2.0**-10)


def test_fam_conv_fused_bf16_plain_matches_pallas():
    args = _conv_inputs(np.random.default_rng(5), (1, 16, 128, 128))
    want = jfb.fam_conv_fused(_j(args[0], jnp.bfloat16), *(_j(a) for a in args[1:]), interpret=True)
    assert want.dtype == jnp.bfloat16
    x = _t(args[0], BF16)
    weights = [_t(a) for a in args[1:]]
    got = tfb.fam_conv_fused_plain(x, *weights)
    staged = tfb.fam_conv_staged_plain(x, *weights)
    assert got.dtype == staged.dtype == BF16
    _within_one_ulp(got, want)
    _within_one_ulp(staged, want)


def test_fam_conv_bf16_stages():
    """y is rounded to bf16 (the JAX kernel's ys scratch), z is f32 and
    unrounded: equal to the f32 convolution of that y."""
    args = _conv_inputs(np.random.default_rng(11), (2, 6, 10, 128))
    x, ka, kb, k1, b1, k32, k42, bt = (_t(a) for a in args)
    xb = x.to(BF16)
    p = tfb.pack_fam_conv(ka, kb, k1, b1, k32, k42, bt, dtype=BF16)
    assert p.dtype == BF16 and p.kab_packed.dtype == BF16 and p.k1_packed.dtype == BF16
    y = tfb.fam_conv_y(xb, p)
    assert y.dtype == BF16
    torch.testing.assert_close(y, tfb.fam_dual_y_plain(xb, k1, b1), rtol=0, atol=0)
    z = tfb.fam_conv_z(y, p)
    assert z.dtype == torch.float32
    k2 = tfb.stack_second_convs(k32, k42)
    want_z = tfb.fam_conv_z_plain(y.float(), k2.to(BF16).float(), bt)
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    assert not torch.equal(z, z.to(BF16).float())  # z carries bits past bf16
    out = tfb.fam_conv_out(z, xb, p)
    assert out.dtype == BF16
    torch.testing.assert_close(out, tfb.fam_conv_staged_plain(xb, ka, kb, k1, b1, k32, k42, bt), rtol=0, atol=0)


@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (1, 16, 128)])
def test_fam_tail_stats_bf16_plain_matches_pallas(b, h, w):
    x, ca_vec, *_ = _tail_inputs(np.random.default_rng(2), b, h, w)
    want = jfb.fam_tail_stats(_j(x, jnp.bfloat16), _j(ca_vec), interpret=True)
    got = tfb.fam_tail_stats_plain(_t(x, BF16), _t(ca_vec))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == (b, h, w, 8)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("layout", ["diag", "dense"])
@pytest.mark.parametrize("b,h,w", [(1, 8, 64), (2, 8, 64)])
def test_fam_tail_apply_g1_bf16_plain_matches_pallas(b, h, w, layout):
    x, ca_vec, sa, wg, wd = _tail_inputs(np.random.default_rng(6), b, h, w)
    wmat = wd if layout == "diag" else wg
    want = jfb.fam_tail_apply_g1(_j(x, jnp.bfloat16), _j(ca_vec), _j(sa, jnp.bfloat16), _j(wmat), interpret=True)
    got = tfb.fam_tail_apply_g1_plain(_t(x, BF16), _t(ca_vec), _t(sa, BF16), _t(wmat))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert tfb.pack_tail_g1(_t(wmat)).diag == (layout == "diag")
    _within_one_ulp(got, want)


@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (1, 16, 128)])
def test_fam_tail_apply_bf16_plain_matches_pallas(b, h, w):
    x, ca_vec, sa, *_ = _tail_inputs(np.random.default_rng(9), b, h, w)
    want = jfb.fam_tail_apply(_j(x, jnp.bfloat16), _j(ca_vec), _j(sa, jnp.bfloat16), interpret=True)
    got = tfb.fam_tail_apply_plain(_t(x, BF16), _t(ca_vec), _t(sa, BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_bf16_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(8)
    args = [_t(a) for a in _conv_inputs(rng, (2, 5, 9, 128))]
    xb = args[0].to(BF16)
    x, ca_vec, sa, wg, wd = _tail_inputs(rng, 2, 5, 9)
    x, ca_vec, sa, wg, wd = _t(x, BF16), _t(ca_vec), _t(sa, BF16), _t(wg), _t(wd)
    tfb.reset_launches()
    p = tfb.pack_fam_conv(*args[1:], dtype=BF16)
    torch.testing.assert_close(tfb.fam_conv_fused(xb, *args[1:], packed=p), tfb.fam_conv_fused_plain(xb, *args[1:]),
                               rtol=0, atol=0)
    torch.testing.assert_close(tfb.fam_tail_stats(x, ca_vec), tfb.fam_tail_stats_plain(x, ca_vec), rtol=0, atol=0)
    for w in (wg, wd, wg[:, :12].contiguous()):
        packed = tfb.pack_tail_g1(w)
        got = tfb.fam_tail_apply_g1(x, ca_vec, sa, w, packed)
        assert got.dtype == BF16 and got.shape == (2, 5, 9, w.shape[1])
        torch.testing.assert_close(got, tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, w), rtol=0, atol=0)
    torch.testing.assert_close(tfb.fam_tail_apply(x, ca_vec, sa), tfb.fam_tail_apply_plain(x, ca_vec, sa), rtol=0, atol=0)
    assert all(n == 0 for n in (*tfb.LAUNCHES.values(), *tfb.KERNEL_LAUNCHES.values(), *tfb.BF16_LAUNCHES.values()))


def test_bf16_wrappers_refuse_mixed_dtypes():
    rng = np.random.default_rng(3)
    args = [_t(a) for a in _conv_inputs(rng, (1, 4, 4, 128))]
    x, ca_vec, sa, wg, _ = (_t(a) for a in _tail_inputs(rng, 1, 4, 4))
    f32_packed = tfb.pack_fam_conv(*args[1:])
    with pytest.raises(ValueError, match="is for torch.float32"):
        tfb.fam_conv_fused(args[0].to(BF16), *args[1:], packed=f32_packed)
    with pytest.raises(ValueError, match="fam_conv_y x"):
        tfb.fam_conv_y(args[0], tfb.pack_fam_conv(*args[1:], dtype=BF16))
    with pytest.raises(ValueError, match="sa"):  # sa in another dtype than x
        tfb.fam_tail_apply(x.to(BF16), ca_vec, sa)
    with pytest.raises(ValueError, match="ca_vec"):  # ca stays f32
        tfb.fam_tail_stats(x.to(BF16), ca_vec.to(BF16))
    with pytest.raises(ValueError, match="w"):  # K6's w stays f32
        tfb.fam_tail_apply_g1(x.to(BF16), ca_vec, sa.to(BF16), wg.to(BF16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfb.fam_tail_stats(x.half(), ca_vec)
