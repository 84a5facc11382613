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


# ---------------------------------------------------------------- K4's stages


def _unpack_pipelined(packed, kh, kw, cin, cout):
    """conv_pipelined's [chunk, tap, 8, Cout_pad] back to HWIO [kh, kw, Cin, Cout]."""
    return packed.transpose(0, 1).reshape(kh, kw, packed.shape[0] * 8, packed.shape[3])[:, :, :cin, :cout]


@pytest.mark.parametrize("shape", [(1, 16, 128, 128), (2, 7, 11, 128)])
def test_fam_conv_staged_plain_matches_pallas(shape):
    """K4 as its three kernels compute it (stage 1's conv, stage 2 on the
    stacked [k32; k42], the pool-and-1x1 stage), each by its plain version,
    against the JAX fam_conv_fused in interpret mode, at K4's tolerance
    (2e-4, tests/test_fused_blocks.py): the existing K4 test's shape, and a
    ragged one (batch 2, h and w no multiples of the TPU's tiles) against
    the JAX package's composition, as the TPU kernel does not take it."""
    from jax import lax

    from retinex_tpu.ops.s2d import maxpool3x3_s1_s2d

    args = _conv_inputs(np.random.default_rng(5), shape)
    x, ka, kb, k1, b1, k32, k42, bt = (jnp.asarray(a) for a in args)
    if jfb.fam_conv_supported(shape):
        want = jfb.fam_conv_fused(x, ka, kb, k1, b1, k32, k42, bt, interpret=True)
    else:
        def conv(v, k):
            return lax.conv_general_dilated(v, k, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))

        y = jnp.maximum(conv(x, k1) + b1, 0.0)
        want = jnp.maximum(
            x @ ka + maxpool3x3_s1_s2d(x) @ kb + conv(y[..., :128], k32) + conv(y[..., 128:], k42) + bt, 0.0
        )
    got = tfb.fam_conv_staged_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_fam_conv_stages_compose_to_the_plain_version():
    """Each stage's wrapper takes its plain version on the CPU (no launch),
    the stages chained reproduce the staged composition bit for bit, and
    that composition holds to K4's plain version within 2e-4."""
    args = [_t(a) for a in _conv_inputs(np.random.default_rng(11), (2, 6, 10, 128))]
    x = args[0]
    p = tfb.pack_fam_conv(*args[1:])
    tfb.reset_launches()
    y = tfb.fam_conv_y(x, p)
    z = tfb.fam_conv_z(y, p)
    out = tfb.fam_conv_out(z, x, p)
    assert y.shape == (2, 6, 10, 256) and z.shape == out.shape == x.shape
    torch.testing.assert_close(out, tfb.fam_conv_staged_plain(*args), rtol=0, atol=0)
    torch.testing.assert_close(out, tfb.fam_conv_fused_plain(*args), rtol=0, atol=2e-4)
    torch.testing.assert_close(tfb.fam_conv_fused(*args, packed=p), tfb.fam_conv_fused_plain(*args), rtol=0, atol=0)
    assert tfb.KERNEL_LAUNCHES == _NO_KERNEL_LAUNCHES
    assert tfb.LAUNCHES["fam_conv_fused"] == 0


def test_fam_conv_packing_round_trips_to_hwio():
    """pack_fam_conv: [k32; k42] stacks the second convs along the input
    channels; the packed k1, k2 and [ka; kb] hold the HWIO weights, which it
    keeps as given."""
    x, ka, kb, k1, b1, k32, k42, bt = (_t(a) for a in _conv_inputs(np.random.default_rng(12), (1, 4, 4, 128)))
    k2 = tfb.stack_second_convs(k32, k42)
    assert k2.shape == (3, 3, 256, 128)
    assert torch.equal(k2[:, :, :128], k32) and torch.equal(k2[:, :, 128:], k42)
    p = tfb.pack_fam_conv(ka, kb, k1, b1, k32, k42, bt)
    assert all(a is b for a, b in zip(p.weights(), (ka, kb, k1, b1, k32, k42, bt)))
    packed = (p.k1_packed, p.k2_packed, p.kab_packed)
    assert [t.shape for t in packed] == [(16, 9, 8, 256), (32, 9, 8, 128), (256, 128)]
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in packed)
    assert torch.equal(_unpack_pipelined(p.k1_packed, 3, 3, 128, 256), k1)
    assert torch.equal(_unpack_pipelined(p.k2_packed, 3, 3, 256, 128), k2)
    assert torch.equal(p.kab_packed, torch.cat([ka, kb]))


def test_packed_forward_packs_k4_once_per_model():
    """PackedRetinex packs each FAM's K4 weights once, from the very tensors
    the plain versions read, and the two forms agree."""
    from retinex_tpu_torch.cli import init_untrained
    from retinex_tpu_torch.models.packed_inference import PackedRetinex
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    packed = PackedRetinex(init_untrained(MultiScaleUPRetinex(False, False), seed=0).eval())
    for fw in (packed.fam1, packed.fam2):
        assert all(a is b for a, b in zip(fw.conv.weights(), (fw.ka, fw.kb, fw.k1, fw.b1, fw.k32, fw.k42, fw.bias_total)))
        assert torch.equal(_unpack_pipelined(fw.conv.k1_packed, 3, 3, 128, 256), fw.k1)
        assert torch.equal(_unpack_pipelined(fw.conv.k2_packed, 3, 3, 256, 128), tfb.stack_second_convs(fw.k32, fw.k42))
        assert torch.equal(fw.conv.kab_packed, torch.cat([fw.ka, fw.kb]))


def test_fam_conv_stage_wrappers_raise_on_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 128)
    conv = [torch.zeros(s) for s in _K4_WEIGHT_SHAPES]
    with pytest.raises(ValueError, match="k1"):
        tfb.pack_fam_conv(conv[0], conv[1], torch.zeros(3, 3, 128, 128), *conv[3:])
    p = tfb.pack_fam_conv(*conv)
    with pytest.raises(ValueError, match="y"):
        tfb.fam_conv_z(x, p)
    with pytest.raises(ValueError, match="z"):
        tfb.fam_conv_out(torch.zeros(1, 4, 5, 128), x, p)
    with pytest.raises(ValueError, match="x"):
        tfb.fam_conv_y(x.to("meta"), p)  # the weights lie on the CPU
    # A FamConvPacked made from other tensors than K4's arguments is refused,
    # even where it holds equal values.
    with pytest.raises(ValueError, match="packed"):
        tfb.fam_conv_fused(x, *conv[:6], torch.zeros(128), packed=p)
    # Off the CPU each goes to its kernel, which takes CUDA tensors only.
    tfb.reset_launches()
    m = x.to("meta")
    pm = tfb.pack_fam_conv(*(t.to("meta") for t in conv))
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_conv_y(m, pm)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_conv_z(torch.zeros(1, 4, 4, 256, device="meta"), pm)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_conv_out(m, m, pm)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_conv_fused(m, *pm.weights())
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fam_conv_fused(m, *pm.weights(), packed=pm)
    assert tfb.KERNEL_LAUNCHES == _NO_KERNEL_LAUNCHES
    assert tfb.LAUNCHES["fam_conv_fused"] == 0


# ---------------------------------------------------------------- K12's stages


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fam_dual_stages_compose_to_the_plain_version(dtype):
    """K12 as its two kernels compute it (y = relu(conv3(x, k1) + b1) rounded
    to x.dtype, then the two half convolutions as one grouped convolution on
    [k2a | k2b]): each stage's wrapper takes its plain version on the CPU
    (no launch), the stages chained equal fam_dual_conv3_plain bit for bit,
    and they hold to the JAX fam_dual_conv3 in interpret mode within K12's
    tolerance (f32 1e-4; bf16 rtol and atol 1e-2, one output ulp)."""
    args = _dual_inputs(np.random.default_rng(13), (1, 16, 128, 128))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jfb.fam_dual_conv3(jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]), interpret=True)
    x, k1, b1, k2a, b2a, k2b, b2b = (_t(a) for a in args)
    x = x.to(dtype)
    k2, b2 = tfb.stack_dual_convs(k2a, b2a, k2b, b2b)
    assert k2.shape == (3, 3, 128, 256) and b2.shape == (256,)
    assert torch.equal(k2[..., :128], k2a) and torch.equal(k2[..., 128:], k2b)
    tfb.reset_launches()
    y = tfb.fam_dual_y(x, k1, b1)
    out = tfb.fam_dual_out(y, k2, b2)
    assert y.dtype == out.dtype == dtype and y.shape == out.shape == (1, 16, 128, 256)
    torch.testing.assert_close(y, tfb.fam_dual_y_plain(x, k1, b1), rtol=0, atol=0)
    torch.testing.assert_close(out, tfb.fam_dual_out_plain(tfb.fam_dual_y_plain(x, k1, b1), k2, b2), rtol=0, atol=0)
    torch.testing.assert_close(out, tfb.fam_dual_conv3_plain(x, k1, b1, k2a, b2a, k2b, b2b), rtol=0, atol=0)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(out.float().numpy(), want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    assert tfb.KERNEL_LAUNCHES == _NO_KERNEL_LAUNCHES
    assert tfb.LAUNCHES["fam_dual_conv3"] == 0


def test_fam_dual_out_plain_is_a_grouped_convolution():
    """fam_dual_out_plain of [k2a | k2b] equals F.conv2d with groups = 2 on
    the channels-first view within f32 rounding, at a ragged shape (the
    'SAME' zero padding at the border, batch 2)."""
    rng = np.random.default_rng(14)
    y = _t(np.abs(rng.standard_normal((2, 7, 11, 256))) * 0.3)
    k2 = _t(rng.standard_normal((3, 3, 128, 256)) * 0.05)
    b2 = _t(rng.standard_normal(256))
    want = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), k2.permute(3, 2, 0, 1), b2, padding=1, groups=2)
    torch.testing.assert_close(tfb.fam_dual_out_plain(y, k2, b2), want.permute(0, 2, 3, 1), rtol=0, atol=1e-5)


def test_fam_dual_stage_wrappers_raise_on_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 128)
    k1, b1 = torch.zeros(3, 3, 128, 256), torch.zeros(256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfb.fam_dual_y(x.double(), k1, b1)
    with pytest.raises(ValueError, match="k1"):
        tfb.fam_dual_y(x, torch.zeros(3, 3, 128, 128), b1)
    with pytest.raises(ValueError, match="y"):
        tfb.fam_dual_out(x, k1, b1)  # 128 channels, not y's 256
    with pytest.raises(ValueError, match="k2"):
        tfb.fam_dual_out(torch.zeros(1, 4, 4, 256), torch.zeros(3, 3, 256, 256), b1)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fam_dual_y(torch.zeros(1, 4, 128, 4).permute(0, 1, 3, 2), k1, b1)
    # Off the CPU each goes to its kernel, which takes CUDA tensors only.
    tfb.reset_launches()
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):
            tfb.fam_dual_y(x.to("meta", dt), k1.to("meta"), b1.to("meta"))
        with pytest.raises(ValueError, match="CUDA"):
            tfb.fam_dual_out(torch.zeros(1, 4, 4, 256, device="meta", dtype=dt), k1.to("meta"), b1.to("meta"))
    assert tfb.KERNEL_LAUNCHES == _NO_KERNEL_LAUNCHES
    assert tfb.LAUNCHES["fam_dual_conv3"] == 0


_NO_KERNEL_LAUNCHES = {
    "fam_conv_y": 0, "fam_conv_z": 0, "fam_conv_out": 0, "fam_tail_apply_g1_diag": 0, "fam_tail_apply_g1_dense": 0,
    "dec1_up": 0, "dec1_c1": 0, "dec1_c2": 0, "dec1_rc": 0,
    "fam_dual_y_pipelined": 0, "fam_dual_y_wgmma": 0, "fam_dual_out_pipelined": 0, "fam_dual_out_wgmma": 0,
}
_K4_WEIGHT_SHAPES = ((128, 128), (128, 128), (3, 3, 128, 256), (256,), (3, 3, 128, 128), (3, 3, 128, 128), (128,))
