"""The port's PackedRetinex against the JAX package's, same weights.

Weights come from the JAX ``model.init`` with numpy-randomised BatchNorm
statistics (fresh statistics would hide scale/mean swaps in the folded
affines), carried across by ``variables_to_state_dict``. On the CPU the
port's FAM runs the kernels' plain versions (K4 -> channel attention -> K5
-> SA conv -> K6, or K11 where the fusion does not fold). Tolerances follow
tests/test_packed_inference.py: illumination atol 2e-5, reflectance and
enhanced atol 2e-3 (X / (I + eps) amplifies float reassociation); 2e-3 on
the enhanced image at the non-fold shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models import packed_inference as jpi
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.models import packed_inference as tpi
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

TOL = (2e-3, 2e-3, 2e-5)  # enhanced, reflectance, illumination


@pytest.fixture(autouse=True)
def _high_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old or "default")


def _nets(use_preact, use_aspp, x, rng):
    model = JaxNet(use_preact=use_preact, use_aspp=use_aspp)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    leaves, treedef = jax.tree_util.tree_flatten(variables["batch_stats"])
    stats = [rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32) for leaf in leaves]
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_unflatten(treedef, stats)}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp).eval()
    port.load_state_dict(variables_to_state_dict(variables, use_preact, use_aspp))
    return model, variables, port


def _run_port(port, x):
    with torch.inference_mode():
        return [a.numpy() for a in tpi.PackedRetinex(port)(torch.from_numpy(x))]


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_packed_matches_jax_packed_and_standard(rng, flags):
    x = rng.random((2, 64, 96, 3), dtype=np.float32) * 0.6 + 0.05
    model, variables, port = _nets(*flags, x, rng)
    want_std = [np.asarray(a) for a in model.apply(variables, jnp.asarray(x), train=False)]
    want_pk = [np.asarray(a) for a in jpi.PackedRetinex(model, variables)(jnp.asarray(x))]
    got = _run_port(port, x)
    for g, ws, wp, tol in zip(got, want_std, want_pk, TOL):
        assert g.shape == ws.shape
        np.testing.assert_allclose(g, ws, atol=tol)
        np.testing.assert_allclose(g, wp, atol=tol)


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_non_fold_shape_matches_jax(rng, flags):
    """32x40: the scale-3 tower's width does not refold, so the fusion runs
    in the direct (resize) form and K11 applies the attention."""
    x = rng.random((1, 32, 40, 3), dtype=np.float32) * 0.8 + 0.1
    model, variables, port = _nets(*flags, x, rng)
    want_std = np.asarray(model.apply(variables, jnp.asarray(x), train=False)[0])
    want_pk = np.asarray(jpi.PackedRetinex(model, variables)(jnp.asarray(x))[0])
    got = _run_port(port, x)[0]
    np.testing.assert_allclose(got, want_std, atol=2e-3)
    np.testing.assert_allclose(got, want_pk, atol=2e-3)


@pytest.mark.parametrize("hw,fold", [((64, 96), True), ((32, 40), False), ((40, 48), False)])
def test_fam_route_calls_the_kernel_wrappers(rng, monkeypatch, hw, fold):
    """Both FAMs go through K4 and K5; then K6 where the fusion folds, K11
    where it does not (40x48: a multiple of 8 but not of 16, as 1080 rows)."""
    calls = {"fam_conv_fused": 0, "fam_tail_stats": 0, "fam_tail_apply_g1": 0, "fam_tail_apply": 0}
    for name in calls:
        fn = getattr(tpi, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tpi, name, counted)
    x = rng.random((1, *hw, 3), dtype=np.float32)
    _run_port(init_untrained(MultiScaleUPRetinex(False, False), seed=0).eval(), x)
    n = 2 if fold else 0
    assert calls == {"fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": n, "fam_tail_apply": 2 - n}


@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_middle_and_inner_match_jax(rng, flags):
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    model, variables, port = _nets(*flags, x, rng)
    x2 = rng.random((1, 16, 16, 64), dtype=np.float32)
    x3 = rng.random((1, 8, 8, 128), dtype=np.float32)
    for method, inp in (("middle", x2), ("inner", x3)):
        want = model.apply(variables, jnp.asarray(inp), False, method=lambda m, a, t: getattr(m.ie_net, method)(a, t))
        with torch.inference_mode():
            got = getattr(port.ie_net, method)(torch.from_numpy(inp).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pack_fam_matches_jax(rng):
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    _, variables, port = _nets(False, False, x, rng)
    want = jpi._pack_fam(variables["params"]["scale1"]["fam"])
    got = tpi._pack_fam(port.scale1[2], "cpu")
    pairs = {"ka": "ka", "kb": "kb", "k1": "dual_k1", "b1": "dual_b1", "k32": "k32f", "k42": "k42f",
             "bias_total": "bias_total"}
    for ours, theirs in pairs.items():
        np.testing.assert_allclose(getattr(got, ours).numpy(), np.asarray(want[theirs]), atol=1e-6, err_msg=ours)
    np.testing.assert_array_equal(
        got.sa.weight.permute(2, 3, 1, 0).numpy(), np.asarray(want["k"]["sa_conv"])
    )


def test_pack_convtranspose2_matches_jax(rng):
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    _, variables, port = _nets(False, False, x, rng)
    for name in ("dec1", "dec2"):
        want = jpi._pack_convtranspose2(variables["params"]["ie_net"][name]["up"]["kernel"])
        got = tpi._pack_convtranspose2(getattr(port.ie_net, name).up.weight)
        np.testing.assert_array_equal(got, np.asarray(want))
