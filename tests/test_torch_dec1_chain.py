"""K10's plain version and the dec1-chain packed forward against the JAX package.

- ``dec1_chain_plain`` against the JAX ``dec1_chain`` (Pallas, interpret
  mode) on tests/test_fused_blocks.py's shapes and scalings, atol 1e-4, and
  on a ragged shape (batch 2, sides not multiples of any tile) against the
  XLA composition.
- ``PackedRetinex(model, NetCfg(dec1_chain=True))`` on the CPU against the
  JAX ``PackedRetinex(..., NetCfg(dec1_chain=True))`` and against the port's
  default cfg, atol 2e-4 (tests/test_packed_inference.py:54-75), for both
  block types; its BatchNorm-folded weights against the JAX package's.
- The route calls the K10 wrapper once per forward with the cfg on, never
  without; on the CPU the wrapper takes the plain version and launches
  nothing, and it raises on what the kernel does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models import packed_inference as jpi
from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.models import packed_inference as tpi
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import fused_blocks as tfb


@pytest.fixture(autouse=True)
def _high_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old or "default")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _chain_inputs(rng, b, h, w):
    """K10 inputs scaled as tests/test_fused_blocks.py::test_dec1_chain_matches_xla."""
    d2 = rng.standard_normal((b, h, w, 64)) * 0.3
    x1p = np.abs(rng.standard_normal((b, h, w, 128))) * 0.3
    ku = rng.standard_normal((1, 1, 64, 128)) * 0.1
    bu = rng.standard_normal((128,)) * 0.1
    args = [d2, x1p, ku, bu]
    for _ in range(3):
        args += [rng.standard_normal((3, 3, 128, 128)) * 0.05, rng.standard_normal((128,)) * 0.1]
    return [np.asarray(a, np.float32) for a in args]


def test_dec1_chain_plain_matches_pallas():
    args = _chain_inputs(np.random.default_rng(1), 1, 16, 128)
    want = jfb.dec1_chain(*(jnp.asarray(a) for a in args), interpret=True)
    got = tfb.dec1_chain_plain(*(_t(a) for a in args))
    assert got.shape == (1, 16, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_dec1_chain_plain_on_a_ragged_shape():
    """The 'SAME' zero padding of every stage at the border of a shape the
    TPU kernel's tiles do not take, against the XLA composition."""
    d2, x1p, ku, bu, k1, b1, k2, b2, k3, b3 = (jnp.asarray(a) for a in _chain_inputs(np.random.default_rng(4), 2, 7, 11))

    def conv(x, k, b, pad):
        return lax.conv_general_dilated(x, k, (1, 1), ((pad, pad), (pad, pad)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    y = conv(d2, ku, bu, 0)
    y = jax.nn.relu(conv(y, k1, b1, 1))
    y = jax.nn.relu(conv(y, k2, b2, 1)) + x1p
    want = jax.nn.relu(conv(y, k3, b3, 1))
    got = tfb.dec1_chain_plain(*(_t(np.array(a)) for a in (d2, x1p, ku, bu, k1, b1, k2, b2, k3, b3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _nets(use_preact, x, rng):
    """JAX and port nets with the same weights and randomised BN statistics."""
    model = JaxNet(use_preact=use_preact, use_aspp=use_preact)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    leaves, treedef = jax.tree_util.tree_flatten(variables["batch_stats"])
    stats = [rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32) for leaf in leaves]
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_unflatten(treedef, stats)}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_preact).eval()
    port.load_state_dict(variables_to_state_dict(variables, use_preact, use_preact))
    return model, variables, port


@pytest.mark.parametrize("use_preact", [False, True])
def test_dec1_chain_forward_matches_jax_and_default(rng, use_preact):
    x = rng.random((1, 32, 48, 3), dtype=np.float32) * 0.7 + 0.1
    model, variables, port = _nets(use_preact, x, rng)
    want = jax.jit(jpi.PackedRetinex(model, variables, jpi.NetCfg(dec1_chain=True)))(jnp.asarray(x))
    with torch.inference_mode():
        got = tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=True))(torch.from_numpy(x))
        base = tpi.PackedRetinex(port)(torch.from_numpy(x))
    for g, w, d in zip(got, want, base):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
        np.testing.assert_allclose(g.numpy(), d.numpy(), atol=2e-4)


def test_folded_dec1_weights_match_jax(rng):
    x = rng.random((1, 32, 48, 3), dtype=np.float32)
    model, variables, port = _nets(False, x, rng)
    want = jpi.PackedRetinex(model, variables)
    got = tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=True)).dec1_fused
    theirs = (want.k_dec1_up, jpi._tile4(want.b_dec1_up), want.dec1_k_c1f, want.dec1_b_c1f,
              want.dec1_k_c2f, want.dec1_b_c2f, want.k_rescv, jpi._tile4(want.b_rescv))
    for i, (a, b) in enumerate(zip(got, theirs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=f"argument {i + 2}")


@pytest.mark.parametrize("dec1", [False, True])
def test_route_calls_k10_once_with_the_cfg_on(rng, monkeypatch, dec1):
    calls = []

    def counted(*a):
        calls.append(a[0].shape)
        return tfb.dec1_chain(*a)

    monkeypatch.setattr(tpi, "dec1_chain", counted)
    port = MultiScaleUPRetinex(False, False).eval()
    with torch.inference_mode():
        tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=dec1))(torch.from_numpy(rng.random((2, 32, 48, 3), dtype=np.float32)))
    assert calls == ([(2, 16, 24, 64)] if dec1 else [])


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    args = [_t(a) for a in _chain_inputs(np.random.default_rng(2), 2, 5, 9)]
    tfb.reset_launches()
    torch.testing.assert_close(tfb.dec1_chain(*args), tfb.dec1_chain_plain(*args), rtol=0, atol=0)
    assert tfb.LAUNCHES["dec1_chain"] == 0
    with pytest.raises(ValueError, match="x1p"):
        tfb.dec1_chain(args[0], args[1][:, :4].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="k_up"):
        tfb.dec1_chain(*args[:2], torch.zeros(1, 1, 128, 128), *args[3:])
    with pytest.raises(ValueError, match="float32"):
        tfb.dec1_chain(args[0].double(), *args[1:])
    # Off the CPU the wrapper goes to its kernel, which takes CUDA tensors only.
    with pytest.raises(ValueError, match="CUDA"):
        tfb.dec1_chain(*(a.to("meta") for a in args))
    assert tfb.LAUNCHES["dec1_chain"] == 0


# ---------------------------------------------------------------- K10's four stages


def _unpack_pipelined(packed, kh, kw, cin, cout):
    """conv_pipelined's [chunk, tap, 8, Cout_pad] back to HWIO [kh, kw, Cin, Cout]."""
    return packed.transpose(0, 1).reshape(kh, kw, packed.shape[0] * 8, packed.shape[3])[:, :, :cin, :cout]


def test_dec1_stages_compose_to_the_plain_version():
    """K10 as its four kernels compute it (the 1x1, two 3x3 stages, the
    third with x1p added after its ReLU, the residual_conv): each stage's
    wrapper takes its plain version on the CPU (no launch), the stages
    chained equal dec1_chain_plain bit for bit, and they hold to the JAX
    dec1_chain in interpret mode within K10's 1e-4."""
    args = _chain_inputs(np.random.default_rng(5), 1, 16, 128)
    want = jfb.dec1_chain(*(jnp.asarray(a) for a in args), interpret=True)
    d2, x1p, *weights = (_t(a) for a in args)
    p = tfb.pack_dec1_chain(*weights)
    tfb.reset_launches()
    y1 = tfb.dec1_up(d2, p)
    y2 = tfb.dec1_c1(y1, p)
    y3 = tfb.dec1_c2(y2, x1p, p)
    out = tfb.dec1_rc(y3, p)
    assert y1.shape == y2.shape == y3.shape == out.shape == (1, 16, 128, 128)
    torch.testing.assert_close(y3, tfb.dec1_conv_plain(y2, weights[4], weights[5]) + x1p, rtol=0, atol=0)
    k_up, b_up, k_c1, b_c1, k_c2, b_c2, k_rc, b_rc = weights
    staged = tfb.dec1_conv_plain(tfb.dec1_up_plain(d2, k_up, b_up), k_c1, b_c1)
    staged = tfb.dec1_conv_plain(tfb.dec1_conv_plain(staged, k_c2, b_c2, x1p), k_rc, b_rc)
    torch.testing.assert_close(out, staged, rtol=0, atol=0)
    torch.testing.assert_close(out, tfb.dec1_chain_plain(d2, x1p, *weights), rtol=0, atol=0)
    torch.testing.assert_close(tfb.dec1_chain(d2, x1p, *weights, packed=p), out, rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
    assert not any(tfb.KERNEL_LAUNCHES.values())
    assert tfb.LAUNCHES["dec1_chain"] == 0


def test_pack_dec1_chain_keeps_the_weights_and_their_kernel_layouts():
    """pack_dec1_chain keeps the eight tensors as given and packs each
    kernel as conv_pipelined reads it (the 1x1 [8, 1, 8, 128], the 3x3s
    [16, 9, 8, 128]); the packed layouts unpack to the HWIO kernels."""
    weights = [_t(a) for a in _chain_inputs(np.random.default_rng(6), 1, 2, 2)[2:]]
    p = tfb.pack_dec1_chain(*weights)
    assert all(a is b for a, b in zip(p.weights(), weights))
    packed = (p.up_packed, p.c1_packed, p.c2_packed, p.rc_packed)
    assert [tuple(t.shape) for t in packed] == [(8, 1, 8, 128)] + [(16, 9, 8, 128)] * 3
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in packed)
    assert torch.equal(_unpack_pipelined(p.up_packed, 1, 1, 64, 128), weights[0])
    for t, k in zip(packed[1:], weights[2::2]):
        assert torch.equal(_unpack_pipelined(t, 3, 3, 128, 128), k)
    with pytest.raises(ValueError, match="k_c2"):
        tfb.pack_dec1_chain(*weights[:4], torch.zeros(3, 3, 128, 64), *weights[5:])


@pytest.mark.parametrize("dec1", [False, True])
def test_packed_forward_packs_k10_once_per_model(rng, monkeypatch, dec1):
    """PackedRetinex packs K10's weights once, in __init__, from the very
    tensors it hands K10, and never during a forward; without the cfg never."""
    made = []

    def counted(*weights):
        made.append(tfb.pack_dec1_chain(*weights))
        return made[-1]

    monkeypatch.setattr(tpi, "pack_dec1_chain", counted)
    port = MultiScaleUPRetinex(False, False).eval()
    packed = tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=dec1))
    assert len(made) == int(dec1)
    with torch.inference_mode():
        for _ in range(2):
            packed(torch.from_numpy(rng.random((1, 32, 48, 3), dtype=np.float32)))
    assert len(made) == int(dec1)
    if dec1:
        assert packed.dec1_packed is made[0]
        assert all(a is b for a, b in zip(made[0].weights(), packed.dec1_fused))


def test_dec1_chain_refuses_a_foreign_packed():
    """A Dec1Packed made from other tensors than dec1_chain's arguments is
    refused, even where it holds equal values; one made from them is taken."""
    d2, x1p, *weights = (_t(a) for a in _chain_inputs(np.random.default_rng(7), 1, 4, 6))
    other = tfb.pack_dec1_chain(*(w.clone() for w in weights))
    with pytest.raises(ValueError, match="packed"):
        tfb.dec1_chain(d2, x1p, *weights, packed=other)
    mine = tfb.pack_dec1_chain(*weights)
    torch.testing.assert_close(tfb.dec1_chain(d2, x1p, *weights, packed=mine), tfb.dec1_chain_plain(d2, x1p, *weights),
                               rtol=0, atol=0)
    # Off the CPU the stages go to their kernels, which take CUDA tensors only.
    pm = tfb.pack_dec1_chain(*(w.to("meta") for w in weights))
    tfb.reset_launches()
    for call in (lambda: tfb.dec1_up(d2.to("meta"), pm), lambda: tfb.dec1_c1(x1p.to("meta"), pm),
                 lambda: tfb.dec1_c2(x1p.to("meta"), x1p.to("meta"), pm), lambda: tfb.dec1_rc(x1p.to("meta"), pm),
                 lambda: tfb.dec1_chain(d2.to("meta"), x1p.to("meta"), *pm.weights(), packed=pm)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="x1p"):
        tfb.dec1_c2(x1p, x1p[:, :2].contiguous(), mine)
    assert not any(tfb.KERNEL_LAUNCHES.values())
    assert tfb.LAUNCHES["dec1_chain"] == 0
