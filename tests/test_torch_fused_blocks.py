"""The FAM kernels' plain versions against the JAX package's Pallas kernels.

``retinex_tpu_torch/ops/fused_blocks.py``'s ``*_plain`` functions against
``retinex_tpu/ops/fused_blocks.py``'s ``fam_conv_fused``, ``fam_tail_stats``,
``fam_tail_apply_g1``, ``fam_tail_apply`` and ``fam_dual_conv3`` in
interpret mode, on the shapes, scalings and tolerances of
tests/test_fused_blocks.py (K4 2e-4, K5 1e-5, K6 1e-4, K11 1e-5, K12 1e-4
in f32; K12 in bf16 at rtol and atol 1e-2, one output ulp: both sides round
y and the output to bf16 once, and a summation order that moves a sum
across a rounding boundary flips one ulp, 2**-8 relative). On
the CPU the wrappers take the plain versions and launch nothing; on any
other device they go to the kernel or raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.ops import fused_blocks as tfb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _conv_inputs(rng, shape):
    """K4 inputs scaled as tests/test_fused_blocks.py::test_fam_conv_fused_matches_xla."""
    b, h, w, cin = shape
    x = np.abs(rng.standard_normal(shape)) * 0.3
    w1 = rng.standard_normal((cin, cin)) * 0.05
    w2 = rng.standard_normal((cin, cin)) * 0.05
    k1 = rng.standard_normal((3, 3, cin, 256)) * 0.05
    b1 = rng.standard_normal((256,)) * 0.1
    k32 = rng.standard_normal((3, 3, cin, cin)) * 0.05
    k42 = rng.standard_normal((3, 3, cin, cin)) * 0.05
    wf = [rng.standard_normal((cin, cin)) * 0.05 for _ in range(4)]
    bf = rng.standard_normal((cin,)) * 0.1
    args = [x, w1 @ wf[0], w2 @ wf[1], k1, b1,
            np.einsum("uvio,op->uvip", k32, wf[2]), np.einsum("uvio,op->uvip", k42, wf[3]), bf]
    return [np.asarray(a, np.float32) for a in args]


def _tail_inputs(rng, b, h, w):
    """K5/K6 inputs scaled as tests/test_fused_blocks.py's tail tests."""
    x = (np.abs(rng.standard_normal((b, h, w, 128))) * 0.4).astype(np.float32)
    ca = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, 32))))
    ca_vec = np.tile(ca, 4).astype(np.float32)
    sa = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, w, 4))))).astype(np.float32)
    wg = (rng.standard_normal((128, 128)) * 0.05).astype(np.float32)
    return x, ca_vec, sa, wg


def _dual_inputs(rng, shape):
    """K12 inputs scaled as tests/test_fused_blocks.py::test_fam_dual_conv3_matches_xla."""
    args = [
        rng.standard_normal(shape) * 0.3,
        rng.standard_normal((3, 3, 128, 256)) * 0.05, rng.standard_normal((256,)),
        rng.standard_normal((3, 3, 128, 128)) * 0.05, rng.standard_normal((128,)),
        rng.standard_normal((3, 3, 128, 128)) * 0.05, rng.standard_normal((128,)),
    ]
    return [np.asarray(a, np.float32) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fam_dual_conv3_plain_matches_pallas(dtype):
    args = _dual_inputs(np.random.default_rng(0), (1, 16, 128, 128))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jfb.fam_dual_conv3(jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]), interpret=True)
    got = tfb.fam_dual_conv3(_t(args[0]).to(dtype), *(_t(a) for a in args[1:]))
    assert got.dtype == dtype and got.shape == (1, 16, 128, 256)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_fam_dual_conv3_plain_on_a_ragged_shape():
    """A shape the TPU kernel's tiles do not take (7 x 11, batch 2) against
    the XLA composition of tests/test_fused_blocks.py."""
    from jax import lax

    args = _dual_inputs(np.random.default_rng(3), (2, 7, 11, 128))
    x, k1, b1, k2a, b2a, k2b, b2b = (jnp.asarray(a) for a in args)

    def conv(v, k, b):
        return lax.conv_general_dilated(v, k, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    y = jnp.maximum(conv(x, k1, b1), 0.0)
    want = jnp.concatenate([conv(y[..., :128], k2a, b2a), conv(y[..., 128:], k2b, b2b)], axis=-1)
    got = tfb.fam_dual_conv3_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_fam_conv_fused_plain_matches_pallas():
    args = _conv_inputs(np.random.default_rng(5), (1, 16, 128, 128))
    want = jfb.fam_conv_fused(*(jnp.asarray(a) for a in args), interpret=True)
    got = tfb.fam_conv_fused_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (1, 16, 128)])
def test_fam_tail_stats_plain_matches_pallas(b, h, w):
    x, ca_vec, _, _ = _tail_inputs(np.random.default_rng(2), b, h, w)
    want = jfb.fam_tail_stats(jnp.asarray(x), jnp.asarray(ca_vec), interpret=True)
    got = tfb.fam_tail_stats_plain(_t(x), _t(ca_vec))
    assert got.shape == (b, h, w, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("b,h,w", [(1, 8, 64), (2, 8, 64)])
def test_fam_tail_apply_g1_plain_matches_pallas(b, h, w):
    x, ca_vec, sa, wg = _tail_inputs(np.random.default_rng(6), b, h, w)
    want = jfb.fam_tail_apply_g1(*(jnp.asarray(a) for a in (x, ca_vec, sa, wg)), interpret=True)
    got = tfb.fam_tail_apply_g1_plain(_t(x), _t(ca_vec), _t(sa), _t(wg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (1, 16, 128)])
def test_fam_tail_apply_plain_matches_pallas(b, h, w):
    x, ca_vec, sa, _ = _tail_inputs(np.random.default_rng(9), b, h, w)
    want = jfb.fam_tail_apply(*(jnp.asarray(a) for a in (x, ca_vec, sa)), interpret=True)
    got = tfb.fam_tail_apply_plain(_t(x), _t(ca_vec), _t(sa))
    assert got.shape == (b, h, w, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fam_conv_fused_plain_on_a_ragged_shape():
    """Shapes the TPU kernel's tiles do not take (h, w not multiples of 8,
    batch 2) against the branch-by-branch composition the fold replaces."""
    from jax import lax

    from retinex_tpu.ops.s2d import maxpool3x3_s1_s2d

    rng = np.random.default_rng(7)
    x, *_ = _conv_inputs(rng, (2, 7, 11, 128))
    w1, w2 = (rng.standard_normal((128, 128)) * 0.05 for _ in range(2))
    k1 = rng.standard_normal((3, 3, 128, 256)) * 0.05
    b1 = rng.standard_normal((256,)) * 0.1
    k32, k42 = (rng.standard_normal((3, 3, 128, 128)) * 0.05 for _ in range(2))
    wf = [rng.standard_normal((128, 128)) * 0.05 for _ in range(4)]
    bf = rng.standard_normal((128,)) * 0.1
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731

    def conv(v, k):
        return lax.conv_general_dilated(v, f(k), (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))

    xj = f(x)
    y = jnp.maximum(conv(xj, k1) + f(b1), 0.0)
    want = jnp.maximum(
        (xj @ f(w1)) @ f(wf[0]) + (maxpool3x3_s1_s2d(xj) @ f(w2)) @ f(wf[1])
        + conv(y[..., :128], k32) @ f(wf[2]) + conv(y[..., 128:], k42) @ f(wf[3]) + f(bf),
        0.0,
    )
    got = tfb.fam_conv_fused_plain(
        _t(x), _t(w1 @ wf[0]), _t(w2 @ wf[1]), _t(k1), _t(b1),
        _t(np.einsum("uvio,op->uvip", k32, wf[2])), _t(np.einsum("uvio,op->uvip", k42, wf[3])), _t(bf),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(8)
    args = [_t(a) for a in _conv_inputs(rng, (2, 5, 9, 128))]
    x, ca_vec, sa, wg = (_t(a) for a in _tail_inputs(rng, 2, 5, 9))
    tfb.reset_launches()
    torch.testing.assert_close(tfb.fam_conv_fused(*args), tfb.fam_conv_fused_plain(*args), rtol=0, atol=0)
    torch.testing.assert_close(tfb.fam_tail_stats(x, ca_vec), tfb.fam_tail_stats_plain(x, ca_vec), rtol=0, atol=0)
    for cout in (128, 12):
        w = wg[:, :cout].contiguous()
        got = tfb.fam_tail_apply_g1(x, ca_vec, sa, w)
        assert got.shape == (2, 5, 9, cout)
        torch.testing.assert_close(got, tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, w), rtol=0, atol=0)
    torch.testing.assert_close(tfb.fam_tail_apply(x, ca_vec, sa), tfb.fam_tail_apply_plain(x, ca_vec, sa), rtol=0, atol=0)
    dual = [_t(a) for a in _dual_inputs(rng, (2, 5, 9, 128))]
    torch.testing.assert_close(tfb.fam_dual_conv3(*dual), tfb.fam_dual_conv3_plain(*dual), rtol=0, atol=0)
    assert tfb.LAUNCHES == {
        "fam_conv_fused": 0, "fam_tail_stats": 0, "fam_tail_apply_g1": 0, "fam_tail_apply": 0, "dec1_chain": 0,
        "fam_dual_conv3": 0,
    }


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 128)
    ca = torch.zeros(1, 128)
    sa = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match="float32"):
        tfb.fam_tail_stats(x.double(), ca)
    with pytest.raises(ValueError, match="float32"):
        tfb.fam_tail_stats(torch.zeros(1, 4, 4, 64), ca)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fam_tail_stats(torch.zeros(1, 4, 128, 4).permute(0, 1, 3, 2), ca)
    with pytest.raises(ValueError, match="sa"):
        tfb.fam_tail_apply(x, ca, torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="multiple of 4"):
        tfb.fam_tail_apply_g1(x, ca, sa, torch.zeros(128, 3))
    with pytest.raises(ValueError, match="k1"):
        tfb.fam_conv_fused(x, torch.zeros(128, 128), torch.zeros(128, 128), torch.zeros(3, 3, 128, 128),
                           torch.zeros(256), torch.zeros(3, 3, 128, 128), torch.zeros(3, 3, 128, 128),
                           torch.zeros(128))
    # Off the CPU a wrapper goes to its kernel, which takes CUDA tensors only:
    # it never falls back to the plain version.
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_tail_stats(x.to("meta"), ca.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_tail_apply(x.to("meta"), ca.to("meta"), sa.to("meta"))
    assert tfb.LAUNCHES["fam_tail_stats"] == tfb.LAUNCHES["fam_tail_apply"] == 0
    dual = [torch.zeros(3, 3, 128, 256), torch.zeros(256), torch.zeros(3, 3, 128, 128), torch.zeros(128),
            torch.zeros(3, 3, 128, 128), torch.zeros(128)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfb.fam_dual_conv3(x.half(), *dual)
    with pytest.raises(ValueError, match="k2b"):
        tfb.fam_dual_conv3(x, *dual[:4], torch.zeros(3, 3, 128, 64), dual[5])
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_dual_conv3(x.to("meta"), *(t.to("meta") for t in dual))
    assert tfb.LAUNCHES["fam_dual_conv3"] == 0
