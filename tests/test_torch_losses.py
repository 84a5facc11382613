"""The port's losses, VGG19 features and TotalLoss against the JAX package's.

The same numpy inputs (seeded) go through both. Tolerances: loss values rtol
1e-4 / atol 1e-5 (tests/test_packed_train.py's for two formulations of one
step); input gradients atol 1e-4 of the gradient's largest magnitude (each
loss is a handful of reductions, so the two sides part only by summation
order; the train-step tests' 1e-2 is for a whole net), and 1e-3 where the
gradient comes back through VGG19's eight convolutions (the perceptual loss
and the total); VGG features atol 1e-4 of the feature's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.losses import losses as JL
from retinex_tpu.losses.total import LossConfig as JLossConfig
from retinex_tpu.losses.total import LossState as JLossState
from retinex_tpu.losses.total import TotalLoss as JTotalLoss
from retinex_tpu.models.vgg import VGG19Features as JVGG
from retinex_tpu.models.vgg import load_npz as jax_load_npz
from retinex_tpu_torch.losses import losses as TL
from retinex_tpu_torch.losses.total import LossConfig, TotalLoss
from retinex_tpu_torch.models.convert import vgg_variables_to_state_dict
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.vgg import VGG19Features, default_vgg, load_npz

RTOL, ATOL = 1e-4, 1e-5

@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers,
    and PyTorch's default of one thread per core oversubscribes the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)



def _inputs(seed=0, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return {
        "low": rng.random((b, h, w, 3), dtype=np.float32) * 0.5,
        "enh": rng.random((b, h, w, 3), dtype=np.float32),
        "illu1": rng.random((b, h, w, 1), dtype=np.float32) * 0.8 + 0.1,
        "illu3": rng.random((b, h, w, 3), dtype=np.float32) * 0.8 + 0.1,
        "refl": rng.random((b, h, w, 3), dtype=np.float32) * 2.0,
    }


def _grad_close(got, want, what, rel=1e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=rel * max(scale, 1e-12), rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def vggs():
    """The JAX package's VGG19Features init (PRNGKey(42), as its trainer) and
    the port's VGG carrying those weights."""
    variables = jax.jit(JVGG().init)(jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = VGG19Features()
    port.load_state_dict(vgg_variables_to_state_dict(variables))
    jax_apply = jax.jit(lambda x: JVGG().apply(variables, x))
    return jax_apply, port, variables


# (name, the port's loss, the JAX package's, the differentiated inputs, the rest)
LOSSES = {
    "exposure": (TL.exposure_loss, JL.exposure_loss, ("enh",), ("low",)),
    "smoothness": (TL.smoothness_loss, JL.smoothness_loss, ("illu1",), ("low",)),
    "color": (TL.color_loss, JL.color_loss, ("enh",), ()),
    "spatial": (TL.spatial_consistency_loss, JL.spatial_consistency_loss, ("enh",), ("low",)),
    "decoupling_1ch": (TL.decoupling_loss, JL.decoupling_loss, ("illu1", "refl"), ()),
    "decoupling_3ch": (TL.decoupling_loss, JL.decoupling_loss, ("illu3", "refl"), ()),
    "frequency": (TL.frequency_loss, JL.frequency_loss, ("enh",), ("low",)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_input_gradients_match_jax(name):
    port_fn, jax_fn, diff, rest = LOSSES[name]
    x = _inputs(seed=1)
    args = diff + rest
    want, want_g = jax.jit(jax.value_and_grad(
        lambda *a: jax_fn(*a), argnums=tuple(range(len(diff)))))(*(jnp.asarray(x[k]) for k in args))
    t = [torch.tensor(x[k], requires_grad=k in diff) for k in args]
    got = port_fn(*t)
    got_g = torch.autograd.grad(got, t[: len(diff)])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    for k, g, wg in zip(diff, got_g, want_g):
        _grad_close(g.numpy(), np.asarray(wg), f"{name}: d/d{k}")


@pytest.mark.parametrize("method", ["tv", "edge_density"])
def test_texture_complexity_matches_jax(method):
    x = _inputs(seed=2)["low"]
    want = np.asarray(JL.texture_complexity(jnp.asarray(x), method))
    got = TL.texture_complexity(torch.from_numpy(x), method).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        TL.texture_complexity(torch.from_numpy(x), "nope")


def test_vgg_features_and_perceptual_loss_match_jax(vggs):
    jax_apply, port, _ = vggs
    x = _inputs(seed=3)
    want = jax_apply(jnp.asarray(x["enh"]))
    got = port(torch.from_numpy(x["enh"]))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * float(np.abs(w).max()), rtol=0, err_msg=f"f{i + 1}")
    # The perceptual loss and its gradient in the enhanced image.
    want_l, want_g = jax.jit(jax.value_and_grad(lambda e, low: JL.perceptual_loss(jax_apply, e, low)))(
        jnp.asarray(x["enh"]), jnp.asarray(x["low"]))
    e = torch.tensor(x["enh"], requires_grad=True)
    got_l = TL.perceptual_loss(port, e, torch.from_numpy(x["low"]))
    (got_g,) = torch.autograd.grad(got_l, e)
    np.testing.assert_allclose(float(got_l.detach()), float(want_l), rtol=RTOL, atol=ATOL)
    _grad_close(got_g.numpy(), np.asarray(want_g), "perceptual: d/denh", rel=1e-3)
    assert not any(p.requires_grad for p in port.parameters())


def test_vgg_npz_round_trip_and_default_draw(vggs, tmp_path):
    """The port's VGG weights exported as torchvision's .npz load into both
    packages with the same features; the default draw is seed 42's."""
    jax_apply, port, _ = vggs
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{k: v.numpy() for k, v in port.state_dict().items()})
    loaded = load_npz(str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    jvars = jax_load_npz(str(path))
    x = _inputs(seed=4, h=32, w=32)["enh"]
    want = JVGG().apply(jvars, jnp.asarray(x))
    for g, w in zip(loaded(torch.from_numpy(x)), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * float(np.abs(w).max()), rtol=0)
    a, b = default_vgg().state_dict(), init_untrained(VGG19Features(), 42).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert list(a) == [f"{i}.{kind}" for i in (0, 2, 5, 7, 10, 12, 14, 16) for kind in ("weight", "bias")]


@pytest.mark.parametrize("use_freq_loss", [False, True])
def test_total_loss_with_dwa_over_three_steps_matches_jax(vggs, use_freq_loss):
    """Three steps with adaptive (DWA) weights, so the third weighs by the
    first two steps' losses; values, the carried state and the total's
    gradient in the enhanced image at every step."""
    jax_apply, port, _ = vggs
    kw = dict(use_freq_loss=use_freq_loss, adaptive_weights=True)
    jax_loss = JTotalLoss(JLossConfig(**kw), vgg_apply=jax_apply)
    port_loss = TotalLoss(LossConfig(**kw), vgg=port)

    @jax.jit
    def jax_step(low, enh, illu, refl, state):
        def f(e):
            total, d, new = jax_loss(low, e, illu, refl, state)
            return total, (d, new)

        (total, (d, new)), g = jax.value_and_grad(f, has_aux=True)(enh)
        return d, new, g

    j_state, p_state = JLossState.create(), None
    for step in range(3):
        x = _inputs(seed=10 + step, h=32, w=32)
        d, j_state, jg = jax_step(*(jnp.asarray(x[k]) for k in ("low", "enh", "illu1", "refl")), j_state)
        e = torch.tensor(x["enh"], requires_grad=True)
        total, pd, p_state = port_loss(
            torch.from_numpy(x["low"]), e, torch.from_numpy(x["illu1"]), torch.from_numpy(x["refl"]), p_state)
        (pg,) = torch.autograd.grad(total, e)
        for k in d:
            np.testing.assert_allclose(float(pd[k].detach()), float(d[k]), rtol=RTOL, atol=ATOL, err_msg=f"step {step}: {k}")
        np.testing.assert_allclose(p_state.prev.numpy(), np.asarray(j_state.prev), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p_state.prev2.numpy(), np.asarray(j_state.prev2), rtol=RTOL, atol=ATOL)
        assert int(p_state.step) == int(j_state.step) == step + 1
        _grad_close(pg.numpy(), np.asarray(jg), f"step {step}: d total / d enh", rel=1e-3)
