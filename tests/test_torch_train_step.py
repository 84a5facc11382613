"""The port's train step against the JAX package's ``make_train_step``
(``donate=False``), the default net (no pre-activation, no ASPP) at
[2,32,32,3], the same weights and batches, perceptual loss on.

One JAX step is compiled per configuration, once for the module: the plain
chain and ``grad_accum=2`` (``optax.MultiSteps``); the train-mode forward is
jitted once too. After the first micro-step of the ``grad_accum=2`` step,
optax's accumulator holds the raw gradient, which the gradient test reads.

Tolerances (tests/test_packed_train.py's for two formulations of one step):
losses rtol 1e-4 / atol 1e-5; BatchNorm statistics atol 1e-4; the forward
atol 5e-4 (illumination 2e-5); gradients and Adam's first moment atol 1e-2
of each leaf's largest magnitude, the second moment (a square) 2e-2. A
convolution's bias right before a BatchNorm has a gradient of 0 (the
normalisation takes the mean out), so both sides hold rounding noise there,
and the deep blocks at 4x4 (32 values a channel) part by up to ~1e-3 of a
small leaf's largest (4e-6 of the whole gradient's largest, measured): each
leaf's scale is floored at 1e-3 of the whole tree's largest magnitude.
Parameters after an Adam step: each side moves a parameter by Adam's first
update, lr * g / (|g| + 1e-8), of its own clipped and decayed gradient
g = clip(grad) + 1e-5 p (0.1 of Adam's first moment after the step, which
is held to the other side's above). So the parameters are held to lr times
the difference of the two sides' updates (up to 2 lr where g is near 0 and
its sign parts; lr * 1e-8 * |dg| / g^2 where g is small but shares its
sign), plus 1e-3 lr and 1e-6 of the parameter for rounding. (A fixed
near-0 threshold on g would miss the second kind: elements of ~1e-6 whose
updates part by more than 1e-3 lr with their signs agreeing.)

The ``grad_accum=2`` step's second batch is one where the JAX package's f32
gradient is itself far from exact: in float64 the two packages agree within
1e-7 of every leaf's largest (the JAX net and losses run with
``jax_enable_x64``, measured on the CPU), while in f32 the JAX package's
gradient of ``ie_net.dec2.conv2`` sits 6.3 % of that leaf's largest (4e-4 of
the whole gradient's largest) from the float64 value and the port's 4e-4 of
it. That step's moments are therefore held at 1e-3 of the whole tree's
largest magnitude (its parameters by the rule above), and the
port's own f32 gradient is held to its float64 gradient on both batches at
the per-leaf 1e-2 (``test_gradients_match_float64``).
"""

import copy

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from retinex_tpu.config import Config as JConfig
from retinex_tpu.losses.total import LossState as JLossState
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.models.retinex_net import count_parameters as jax_count
from retinex_tpu.train.train_state import RetinexTrainState, make_optimizer, make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import adam_state_to_optax, adam_state_to_port, state_dict_to_variables
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex, count_parameters
from retinex_tpu_torch.models.vgg import default_vgg
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads, train_step
from retinex_tpu_torch.train.trainer import build_criterion

LR = 1e-4
SHAPE = (2, 32, 32, 3)
OUT_TOL = {"enhanced": 5e-4, "reflectance": 5e-4, "illumination": 2e-5}

@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers,
    and PyTorch's default of one thread per core oversubscribes the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)



def batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.random(SHAPE, dtype=np.float32) * 0.6 for _ in range(n)]


def port_model(use_preact, use_aspp, seed=0):
    """Seeded weights, BatchNorm scales and biases moved off identity and
    running statistics drawn from numpy (so their 0.9 decay shows)."""
    model = init_untrained(MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp), seed)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                t.copy_(torch.from_numpy(rng.uniform(0.2, 1.5, t.shape).astype(np.float32)))
            elif ".bn" in name or "shortcut.1" in name or name.endswith((".conv.1.weight", ".conv.4.weight")):
                if name.endswith("weight"):
                    t.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, t.shape).astype(np.float32)))
    return model


def save_vgg_npz(path):
    """The port's default VGG19 as torchvision's .npz, for the JAX criterion."""
    np.savez(path, **{k: v.numpy() for k, v in default_vgg().state_dict().items()})
    return str(path)


def jax_state(model, grad_accum, use_aspp):
    variables = state_dict_to_variables(model.state_dict(), use_aspp)
    return RetinexTrainState.create(
        apply_fn=None,
        params=variables["params"],
        tx=make_optimizer(lambda s: LR, grad_accum=grad_accum),
        batch_stats=variables["batch_stats"],
        loss_state=JLossState.create(),
        dropout_rng=jax.random.PRNGKey(1),
    )


def adam_of(opt_state):
    return [s for s in jtu.tree_leaves(opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


def floor_of(tree) -> float:
    return 1e-3 * max(float(np.abs(np.asarray(v)).max()) for v in jtu.tree_leaves(tree))


def tree_close(got, want, what, rel=None, atol=None):
    """Leaf by leaf: atol `atol`, or `rel` of each leaf's largest magnitude
    (floored, module docstring)."""
    assert jtu.tree_structure(got) == jtu.tree_structure(want), what
    floor = floor_of(want) if atol is None else 0.0

    def check(path, g, w):
        g, w = np.asarray(g), np.asarray(w)
        tol = atol if atol is not None else rel * max(float(np.abs(w).max()), floor, 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} {jtu.keystr(path)}")

    jtu.tree_map_with_path(check, got, want)


def params_close(got, want, eff_got, eff_want, what):
    """Parameters after a first Adam step (module docstring); eff_* are
    each side's clipped, decayed gradient (Adam's first moment / 0.1)."""

    def check(path, g, w, gg, gw):
        g, w, gg, gw = (np.asarray(a, np.float64) for a in (g, w, gg, gw))
        allowed = LR * (np.abs(gg / (np.abs(gg) + 1e-8) - gw / (np.abs(gw) + 1e-8)) + 1e-3) + 1e-6 * np.abs(w)
        bad = np.abs(g - w) > allowed
        assert not bad.any(), f"{what} {jtu.keystr(path)}: {int(bad.sum())} of {bad.size}, max {np.abs(g - w).max():.3e}"

    jtu.tree_map_with_path(check, got, want, eff_got, eff_want)


def losses_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5, err_msg=f"{what}: {k}")


def port_moments(opt, use_aspp):
    mu, nu, count = adam_state_to_optax({"mu": opt.mu, "nu": opt.nu, "count": opt.count}, use_aspp)
    return mu, nu, count


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    use_preact, use_aspp = False, False
    model = port_model(use_preact, use_aspp)
    npz = save_vgg_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    jcfg = JConfig(use_preact=use_preact, use_aspp=use_aspp, vgg_weights=npz)
    jnet = JNet(use_preact=use_preact, use_aspp=use_aspp)
    jcrit = jax_build_criterion(jcfg)
    step1 = make_train_step(jnet, jcrit, donate=False)
    step2 = make_train_step(jnet, jcrit, donate=False)
    xs = batches(2)
    s1, l1 = step1(jax_state(model, 1, use_aspp), jnp.asarray(xs[0]))
    a1, la1 = step2(jax_state(model, 2, use_aspp), jnp.asarray(xs[0]))
    a2, la2 = step2(a1, jnp.asarray(xs[1]))
    fwd = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)}))
    variables = state_dict_to_variables(model.state_dict(), use_aspp)
    (outs, upd) = fwd(variables, jnp.asarray(xs[0]))
    crit = build_criterion(Config(use_preact=use_preact, use_aspp=use_aspp, vgg_weights=npz), torch.device("cpu"))
    return dict(model=model, crit=crit, xs=xs, use_aspp=use_aspp, forward=(outs, upd["batch_stats"]),
                step=(s1, l1), accum=((a1, la1), (a2, la2)))


def test_reverse_map_equals_the_jax_converter(setup):
    """state_dict_to_variables (port -> Flax) gives the JAX package's own
    converter's pytree, leaf for leaf."""
    model, use_aspp = setup["model"], setup["use_aspp"]
    want = torch_state_dict_to_variables(model.state_dict(), False, use_aspp)
    got = state_dict_to_variables(model.state_dict(), use_aspp)
    tree_close(got, want, "variables", atol=0.0)


def test_count_parameters_matches_jax(setup):
    model = setup["model"]
    want = jax_count(torch_state_dict_to_variables(model.state_dict(), False, setup["use_aspp"])["params"])
    assert count_parameters(model) == want == 4_275_475


def test_train_mode_forward_and_batch_stats_match_jax(setup):
    model = copy.deepcopy(setup["model"]).train()
    (outs, stats) = setup["forward"]
    with torch.no_grad():
        got = model(torch.from_numpy(setup["xs"][0]))
    for (name, tol), g, w in zip(OUT_TOL.items(), got, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, err_msg=name)
    got_stats = state_dict_to_variables(model.state_dict(), setup["use_aspp"])["batch_stats"]
    tree_close(got_stats, jax.tree_util.tree_map(np.asarray, stats), "batch_stats", atol=1e-4)
    # The eval forward reads the updated running statistics.
    model.eval()
    with torch.no_grad():
        assert all(torch.isfinite(o).all() for o in model(torch.from_numpy(setup["xs"][0])))


def test_gradients_match_jax(setup):
    """The raw gradient: optax's accumulator after the first micro-step of
    the grad_accum=2 step (whose parameters stay as they were)."""
    state = create_train_state(copy.deepcopy(setup["model"]), lambda s: LR)
    grads, loss_dict, _ = loss_and_grads(state, setup["crit"], torch.from_numpy(setup["xs"][0]))
    (a1, la1), _ = setup["accum"]
    losses_close(loss_dict, la1, "losses")
    want = jax.tree_util.tree_map(np.asarray, a1.opt_state.acc_grads)
    tree_close(state_dict_to_variables(grads, setup["use_aspp"])["params"], want, "gradients", rel=1e-2)
    tree_close(jax.tree_util.tree_map(np.asarray, a1.params),
               jax.tree_util.tree_map(np.asarray, setup_params(setup)), "params held", atol=0.0)


def test_gradients_match_float64(setup):
    """The port's f32 gradient on each batch against its own float64
    gradient (the same model, losses and VGG in float64), per leaf at 1e-2
    of the leaf's largest magnitude (floored as above)."""
    old = torch.get_default_dtype()
    try:
        for x in setup["xs"]:
            torch.set_default_dtype(torch.float32)
            g32, _, _ = loss_and_grads(create_train_state(copy.deepcopy(setup["model"]), lambda s: LR),
                                       setup["crit"], torch.from_numpy(x))
            torch.set_default_dtype(torch.float64)
            crit64 = copy.deepcopy(setup["crit"])
            crit64.vgg.double()
            g64, _, _ = loss_and_grads(create_train_state(copy.deepcopy(setup["model"]).double(), lambda s: LR),
                                       crit64, torch.from_numpy(x).double())
            want = state_dict_to_variables({k: v.float() for k, v in g64.items()}, setup["use_aspp"])["params"]
            tree_close(state_dict_to_variables(g32, setup["use_aspp"])["params"], want, "f32 vs f64", rel=1e-2)
    finally:
        torch.set_default_dtype(old)


def setup_params(setup):
    return state_dict_to_variables(setup["model"].state_dict(), setup["use_aspp"])["params"]


def test_one_train_step_matches_jax(setup):
    """Loss dict, BatchNorm statistics, parameters and Adam's moments and
    count after one step."""
    s1, l1 = setup["step"]
    state = create_train_state(copy.deepcopy(setup["model"]), lambda s: LR)
    losses_close(train_step(state, setup["crit"], torch.from_numpy(setup["xs"][0])), l1, "losses")
    assert state.step == int(s1.step) == 1
    use_aspp = setup["use_aspp"]
    got = state_dict_to_variables(state.model.state_dict(), use_aspp)
    tree_close(got["batch_stats"], jax.tree_util.tree_map(np.asarray, s1.batch_stats), "batch_stats", atol=1e-4)
    adam = adam_of(s1.opt_state)
    mu, nu, count = port_moments(state.optimizer, use_aspp)
    assert count == int(adam.count) == 1
    want_mu, want_nu = (jax.tree_util.tree_map(np.asarray, t) for t in (adam.mu, adam.nu))
    tree_close(mu, want_mu, "mu", rel=1e-2)
    tree_close(nu, want_nu, "nu", rel=2e-2)
    # optax's state carried into the port's moments and back, exactly.
    moments = adam_state_to_port(adam.mu, adam.nu, adam.count, use_aspp)
    assert moments["count"] == 1 and set(moments["mu"]) == set(state.optimizer.mu)
    tree_close(adam_state_to_optax(moments, use_aspp)[0], want_mu, "mu round trip", atol=0.0)
    # What Adam's sign follows: clip(g) + 1e-5 p = mu / 0.1 (the decay can cancel a small gradient).
    eff_got, eff_want = (jax.tree_util.tree_map(lambda m: m / 0.1, t) for t in (mu, want_mu))
    params_close(got["params"], jax.tree_util.tree_map(np.asarray, s1.params), eff_got, eff_want, "params")
    np.testing.assert_allclose(state.loss_state.prev.numpy(), np.asarray(s1.loss_state.prev), rtol=1e-4, atol=1e-5)


def test_grad_accum_two_steps_match_optax_multisteps(setup):
    """grad_accum=2: the first micro-step leaves the parameters and updates
    the BatchNorm statistics; the second applies the clipped mean of both
    gradients; the learning rate counts applied updates."""
    (a1, la1), (a2, la2) = setup["accum"]
    use_aspp = setup["use_aspp"]
    seen = []
    state = create_train_state(copy.deepcopy(setup["model"]), lambda s: seen.append(s) or LR, grad_accum=2)
    before = state_dict_to_variables(state.model.state_dict(), use_aspp)["params"]
    losses_close(train_step(state, setup["crit"], torch.from_numpy(setup["xs"][0])), la1, "micro-step 1")
    mid = state_dict_to_variables(state.model.state_dict(), use_aspp)
    tree_close(mid["params"], before, "params after micro-step 1", atol=0.0)
    tree_close(mid["batch_stats"], jax.tree_util.tree_map(np.asarray, a1.batch_stats), "batch_stats 1", atol=1e-4)
    losses_close(train_step(state, setup["crit"], torch.from_numpy(setup["xs"][1])), la2, "micro-step 2")
    assert seen == [0] and state.optimizer.count == 1 and state.optimizer.mini_step == 0 and state.step == 2
    got = state_dict_to_variables(state.model.state_dict(), use_aspp)
    tree_close(got["batch_stats"], jax.tree_util.tree_map(np.asarray, a2.batch_stats), "batch_stats 2", atol=1e-4)
    adam = adam_of(a2.opt_state)
    assert int(adam.count) == 1 and int(a2.opt_state.mini_step) == 0 and int(a2.opt_state.gradient_step) == 1
    mu, nu, _ = port_moments(state.optimizer, use_aspp)
    want_mu, want_nu = (jax.tree_util.tree_map(np.asarray, t) for t in (adam.mu, adam.nu))
    tree_close(mu, want_mu, "mu", atol=floor_of(want_mu))
    tree_close(nu, want_nu, "nu", atol=2 * floor_of(want_nu))
    # The mean gradient: mu = 0.1 * (clip(mean) + 1e-5 p); its sign decides the update.
    mean_got = jax.tree_util.tree_map(lambda m: m / 0.1, mu)
    mean_want = jax.tree_util.tree_map(lambda m: m / 0.1, want_mu)
    params_close(got["params"], jax.tree_util.tree_map(np.asarray, a2.params), mean_got, mean_want, "params")
    assert all(not np.asarray(v).any() for v in jtu.tree_leaves(a2.opt_state.acc_grads))
    assert all(not v.any() for v in state.optimizer.acc.values())
