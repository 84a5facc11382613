"""K10 in bf16 (``NetCfg(dec1_chain=True)`` with a bf16 model) against the
JAX package.

- ``dec1_chain_plain`` on bf16 inputs against the JAX ``dec1_chain``
  (Pallas, interpret mode) in bf16, on tests/test_fused_blocks.py's shape
  and scalings and on a batch of two: within one bf16 ulp of the output at
  its largest magnitude (2**-7 at an output of 1 to 2). Both sum exact
  bf16 x bf16 products in f32, in other orders, so a y1, y2 or y3 rounds
  the other way now and then and moves the later stages' small outputs by
  more than their own ulp (seen: 9 of 262144 values past rtol 2**-7 with
  atol 2**-10, by up to 1.6e-3).
- Stage by stage: each of K10's four plain stages (``dec1_up``,
  ``dec1_c1``, ``dec1_c2`` with x1p, ``dec1_rc``) on the JAX side's own
  previous stage, against that stage computed at the JAX kernel's rounding
  points (``lax.conv_general_dilated`` of bf16 operands with
  ``preferred_element_type=f32``, the f32 bias and ReLU, the residual added
  in f32, one rounding: ``retinex_tpu/ops/fused_blocks.py:218-237``), run
  eagerly: one stage rounds once, so each value within its own ulp (rtol
  2**-7, atol 2**-10 as tests/test_torch_amp_kernels.py); the JAX stages
  composed equal the interpret-mode kernel within one ulp at the output's
  largest magnitude.
- The bf16 dec1-chain forward, ``PackedRetinex(bf16 model,
  NetCfg(dec1_chain=True))`` on the CPU, against the JAX package's bf16
  packed forward with the cfg on (jitted). On the CPU the JAX package does
  not take K10 (``retinex_tpu/models/packed_inference.py:627-631``): it runs
  its XLA chain, which rounds dec1's ReLU output to bf16 before it adds
  x1p, where the kernel adds in f32 and rounds once (ROADMAP, "Divergences
  inside the JAX package"). So the forward is held at the bf16 packed
  forward's tolerances (tests/test_torch_amp_net.py: enhanced 1.1e-2,
  reflectance 1.4e-2, illumination two ulps at 1, 2**-7), and to the port's
  default bf16 packed forward (dec1 as the XLA chain's counterpart) at the
  same.
- The route calls K10 once per forward in bf16; the folded kernels,
  rounded to bf16, equal the JAX package's folds cast as its kernel casts
  them (``fused_blocks.py:293-298``), bit for bit; the biases stay f32,
  held as tests/test_torch_dec1_chain.py holds the f32 folds (rtol 1e-6:
  a folded bias b * scale + shift parts from the JAX package's by one f32
  ulp on a few channels).
- ``pack_dec1_chain(..., bfloat16)`` keeps the f32 weights and packs each
  kernel as ``conv_wgmma`` reads it; the wrappers take the plain versions
  on the CPU (no launch, no count) and refuse a mismatched dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from retinex_tpu.models import packed_inference as jpi
from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.models import packed_inference as tpi
from retinex_tpu_torch.ops import conv_pallas as tcp
from retinex_tpu_torch.ops import fused_blocks as tfb
from test_torch_amp_net import _jax, _port

BF16 = torch.bfloat16
ULP = 2.0**-7
ATOL = 2.0**-10
NET_TOL = {"enhanced": 1.1e-2, "reflectance": 1.4e-2, "illumination": 2.0**-7}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_one_ulp(got, want, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=ULP, atol=ATOL, err_msg=what)


def _within_one_ulp_at_largest(got, want, what=""):
    """One bf16 ulp at the largest magnitude of `want`."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(_f32(want)).max())) - 7)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=ulp, err_msg=what)


def _chain_inputs(rng, b, h, w):
    """K10's inputs scaled as tests/test_fused_blocks.py::test_dec1_chain_matches_xla:
    d2 and x1p rounded to bf16, the weights f32."""
    d2 = _t(rng.standard_normal((b, h, w, 64)) * 0.3, BF16)
    x1p = _t(np.abs(rng.standard_normal((b, h, w, 128))) * 0.3, BF16)
    weights = [rng.standard_normal((1, 1, 64, 128)) * 0.1, rng.standard_normal((128,)) * 0.1]
    for _ in range(3):
        weights += [rng.standard_normal((3, 3, 128, 128)) * 0.05, rng.standard_normal((128,)) * 0.1]
    return d2, x1p, [_t(a) for a in weights]


def _j(t: torch.Tensor):
    """A port tensor as a JAX array of its dtype."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF16 else a


def _jax_stage(x, k, b, pad, relu, residual=None):
    """One K10 stage at the JAX kernel's rounding points: bf16 operands,
    f32 accumulation, f32 bias (and ReLU, and residual), one rounding."""
    acc = lax.conv_general_dilated(x, k.astype(jnp.bfloat16), (1, 1), ((pad, pad), (pad, pad)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    acc = acc + b
    if relu:
        acc = jnp.maximum(acc, 0.0)
    if residual is not None:
        acc = acc + residual.astype(jnp.float32)
    return acc.astype(jnp.bfloat16)


@pytest.fixture(scope="module", params=[(1, 16, 128), (2, 8, 64)], ids=["1x16x128", "2x8x64"])
def chain(request):
    """Inputs, the JAX interpret-mode kernel's output and the JAX stages."""
    d2, x1p, weights = _chain_inputs(np.random.default_rng(11 + request.param[0]), *request.param)
    jw = [_j(w) for w in weights]
    want = jfb.dec1_chain(_j(d2), _j(x1p), *jw, interpret=True)
    ku, bu, k1, b1, k2, b2, k3, b3 = jw
    y1 = _jax_stage(_j(d2), ku, bu, 0, False)
    y2 = _jax_stage(y1, k1, b1, 1, True)
    y3 = _jax_stage(y2, k2, b2, 1, True, _j(x1p))
    out = _jax_stage(y3, k3, b3, 1, True)
    return dict(d2=d2, x1p=x1p, weights=weights, kernel=want, stages=(y1, y2, y3, out))


def test_plain_version_matches_the_interpret_mode_kernel(chain):
    want = chain["kernel"]
    assert want.dtype == jnp.bfloat16
    got = tfb.dec1_chain_plain(chain["d2"], chain["x1p"], *chain["weights"])
    assert got.dtype == BF16 and got.shape == want.shape
    _within_one_ulp_at_largest(got, want)
    # The wrapper on the CPU is the plain version, and launches nothing.
    tfb.reset_launches()
    p = tfb.pack_dec1_chain(*chain["weights"], dtype=BF16)
    torch.testing.assert_close(tfb.dec1_chain(chain["d2"], chain["x1p"], *chain["weights"], packed=p), got,
                               rtol=0, atol=0)
    assert not any(tfb.BF16_LAUNCHES.values()) and not any(tfb.KERNEL_LAUNCHES.values())


def test_each_stage_matches_the_jax_kernels_rounding_points(chain):
    """Each plain stage on the JAX side's previous stage, one ulp; the JAX
    stages composed are the interpret-mode kernel within one ulp."""
    y1, y2, y3, out = chain["stages"]
    ku, bu, k1, b1, k2, b2, k3, b3 = chain["weights"]
    p = tfb.pack_dec1_chain(*chain["weights"], dtype=BF16)
    bf = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(BF16)  # noqa: E731
    got = {
        "dec1_up": tfb.dec1_up(chain["d2"], p),
        "dec1_c1": tfb.dec1_c1(bf(y1), p),
        "dec1_c2": tfb.dec1_c2(bf(y2), chain["x1p"], p),
        "dec1_rc": tfb.dec1_rc(bf(y3), p),
    }
    plain = {
        "dec1_up": tfb.dec1_up_plain(chain["d2"], ku, bu),
        "dec1_c1": tfb.dec1_conv_plain(bf(y1), k1, b1),
        "dec1_c2": tfb.dec1_conv_plain(bf(y2), k2, b2, chain["x1p"]),
        "dec1_rc": tfb.dec1_conv_plain(bf(y3), k3, b3),
    }
    for (name, g), want in zip(got.items(), (y1, y2, y3, out)):
        assert g.dtype == BF16, name
        torch.testing.assert_close(g, plain[name], rtol=0, atol=0)
        _within_one_ulp(g, want, name)
    _within_one_ulp_at_largest(out, chain["kernel"], "the JAX stages against the kernel")


def _nets(use_preact, seed):
    """A bf16 port net with numpy BatchNorm statistics and a JAX bf16 net
    with the same weights (tests/test_torch_amp_net.py's)."""
    port = _port(use_preact, use_preact, seed)
    return (port, *_jax(port))


@pytest.mark.parametrize("use_preact", [False, True], ids=["post_act", "preact_aspp"])
def test_bf16_dec1_chain_forward_matches_jax_and_default(use_preact):
    port, model, variables = _nets(use_preact, 21 + use_preact)
    x = np.random.default_rng(22).random((2, 32, 64, 3), dtype=np.float32) * 0.6 + 0.05
    want = jax.jit(jpi.PackedRetinex(model, variables, jpi.NetCfg(dec1_chain=True)))(jnp.asarray(x))
    with torch.inference_mode():
        got = tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=True))(torch.from_numpy(x))
        base = tpi.PackedRetinex(port)(torch.from_numpy(x))
    assert [g.dtype for g in got] == [torch.float32, torch.float32, BF16]
    for (name, tol), g, w, d in zip(NET_TOL.items(), got, want, base):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(_f32(g), _f32(d), rtol=0, atol=tol, err_msg=name)


def test_route_calls_k10_once_in_bf16(monkeypatch):
    calls = []

    def counted(*a):
        calls.append((a[0].shape, a[0].dtype, a[1].dtype, a[-1].dtype))
        return tfb.dec1_chain(*a)

    monkeypatch.setattr(tpi, "dec1_chain", counted)
    port, _, _ = _nets(False, 5)
    x = torch.from_numpy(np.random.default_rng(6).random((2, 32, 48, 3), dtype=np.float32))
    with torch.inference_mode():
        tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=True))(x)
        tpi.PackedRetinex(port)(x)
    assert calls == [((2, 16, 24, 64), BF16, BF16, BF16)]


def test_folded_bf16_weights_match_jax():
    port, model, variables = _nets(False, 8)
    theirs = jpi.PackedRetinex(model, variables)
    ours = tpi.PackedRetinex(port, tpi.NetCfg(dec1_chain=True))
    want = (theirs.k_dec1_up, jpi._tile4(theirs.b_dec1_up), theirs.dec1_k_c1f, theirs.dec1_b_c1f,
            theirs.dec1_k_c2f, theirs.dec1_b_c2f, theirs.k_rescv, jpi._tile4(theirs.b_rescv))
    p = ours.dec1_packed
    assert p.dtype == BF16 and all(a is b for a, b in zip(p.weights(), ours.dec1_fused))
    for i, (a, b) in enumerate(zip(ours.dec1_fused, want)):
        assert a.dtype == torch.float32, i
        if i % 2 == 0:  # a kernel: JAX casts its f32 fold to bf16 inside dec1_chain
            np.testing.assert_array_equal(_f32(a.to(BF16)), _f32(jnp.asarray(b).astype(jnp.bfloat16)),
                                          err_msg=f"argument {i + 2}")
        else:  # a bias: f32 in both, as tests/test_torch_dec1_chain.py holds the f32 folds
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=1e-6, atol=1e-7,
                                       err_msg=f"argument {i + 2}")


def _unpack_wgmma(packed, kh, kw, cin, cout):
    """conv_wgmma's [tap, chunk, Cout_pad, ck] back to HWIO [kh, kw, Cin, Cout]."""
    taps, chunks, cout_pad, ck = packed.shape
    return packed.transpose(2, 3).reshape(kh, kw, chunks * ck, cout_pad)[:, :, :cin, :cout]


def test_pack_dec1_chain_in_bf16_and_the_wrappers_checks():
    d2, x1p, weights = _chain_inputs(np.random.default_rng(9), 1, 4, 6)
    p = tfb.pack_dec1_chain(*weights, dtype=BF16)
    assert all(a is b for a, b in zip(p.weights(), weights)) and p.dtype == BF16
    packed = (p.up_packed, p.c1_packed, p.c2_packed, p.rc_packed)
    assert [tuple(t.shape) for t in packed] == [(1, 1, 128, 64)] + [(9, 2, 128, 64)] * 3
    assert all(t.is_contiguous() and t.dtype == BF16 for t in packed)
    assert torch.equal(_unpack_wgmma(p.up_packed, 1, 1, 64, 128), weights[0].to(BF16))
    for t, k in zip(packed[1:], weights[2::2]):
        assert torch.equal(_unpack_wgmma(t, 3, 3, 128, 128), k.to(BF16))
        assert tuple(t.shape) == tuple(tcp.pack_wgmma(k).shape)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfb.pack_dec1_chain(*weights, dtype=torch.float16)
    f32 = tfb.pack_dec1_chain(*weights)
    with pytest.raises(ValueError, match="packed"):  # a packing for the other dtype
        tfb.dec1_chain(d2, x1p, *weights, packed=f32)
    with pytest.raises(ValueError, match="x1p"):  # x1p in another dtype than d2
        tfb.dec1_chain(d2, x1p.float(), *weights)
    with pytest.raises(ValueError, match="bfloat16"):  # a stage given f32 under a bf16 packing
        tfb.dec1_c1(x1p.float(), p)
    # Off the CPU the stages go to their kernels, which take CUDA tensors only.
    pm = tfb.pack_dec1_chain(*(w.to("meta") for w in weights), dtype=BF16)
    tfb.reset_launches()
    for call in (lambda: tfb.dec1_up(d2.to("meta"), pm), lambda: tfb.dec1_c2(x1p.to("meta"), x1p.to("meta"), pm),
                 lambda: tfb.dec1_chain(d2.to("meta"), x1p.to("meta"), *pm.weights(), packed=pm)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert not any(tfb.BF16_LAUNCHES.values())
