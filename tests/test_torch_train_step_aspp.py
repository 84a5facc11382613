"""The port's train step against the JAX package's for the pre-activation +
ASPP net, whose ASPP fusion ends in the one dropout, at [2,32,32,3].

The two packages draw the dropout mask from different generators (threefry
keys against a torch.Generator), so the JAX package's own mask is read from
its train-mode forward (``capture_intermediates``, the key its train step
folds in) and given to the port's dropout; with it, the step agrees, so the
mask is the only difference. Tolerances and the parameter rule as in
tests/test_torch_train_step.py; one JAX step and one forward are compiled
for the module.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.config import Config as JConfig
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.layers import Dropout
from retinex_tpu_torch.train.train_state import create_train_state, train_step
from retinex_tpu_torch.train.trainer import build_criterion
from test_torch_train_step import (
    LR,
    OUT_TOL,
    adam_of,
    batches,
    jax_state,
    losses_close,
    params_close,
    port_model,
    port_moments,
    save_vgg_npz,
    tree_close,
)

@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers,
    and PyTorch's default of one thread per core oversubscribes the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)



@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = port_model(True, True)
    npz = save_vgg_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    jnet = JNet(use_preact=True, use_aspp=True)
    x = batches(1, seed=9)[0]
    state = jax_state(model, 1, True)
    s1, l1 = make_train_step(jnet, jax_build_criterion(JConfig(use_preact=True, use_aspp=True, vgg_weights=npz)),
                             donate=False)(state, jnp.asarray(x))
    # The key the train step's forward draws from (train_state.py:117).
    key = jax.random.fold_in(state.dropout_rng, state.step)
    fwd = jax.jit(lambda v, xx: jnet.apply(v, xx, train=True, mutable=["batch_stats", "intermediates"],
                                           capture_intermediates=True, rngs={"dropout": key}))
    outs, upd = fwd({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x))
    aspp = upd["intermediates"]["ie_net"]["aspp"]
    dropped = np.asarray(aspp["Dropout_0"]["__call__"][0])
    live = np.asarray(aspp["fusion"]["__call__"][0]) != 0
    keep = torch.from_numpy(dropped != 0).permute(0, 3, 1, 2)  # where the input is 0 either choice gives 0
    rate = float((dropped[live] == 0).mean())
    crit = build_criterion(Config(use_preact=True, use_aspp=True, vgg_weights=npz), torch.device("cpu"))
    return dict(model=model, x=x, keep=keep, rate=rate, forward=(outs, upd["batch_stats"]), step=(s1, l1), crit=crit)


def with_mask(model, keep):
    """The model with its dropout drawing `keep` (Flax's rule: x / 0.9 where kept)."""
    model = copy.deepcopy(model)
    (drop,) = [m for m in model.modules() if isinstance(m, Dropout)]
    drop.forward = lambda t: torch.where(keep, t / (1.0 - drop.p), torch.zeros_like(t))
    return model


def test_forward_with_the_jax_mask_matches_jax(setup):
    (outs, stats) = setup["forward"]
    keep = setup["keep"]
    assert 0.05 < setup["rate"] < 0.15  # Flax's rate 0.1 over the nonzero inputs
    model = with_mask(setup["model"], keep).train()
    with torch.no_grad():
        got = model(torch.from_numpy(setup["x"]))
    for (name, tol), g, w in zip(OUT_TOL.items(), got, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, err_msg=name)
    tree_close(state_dict_to_variables(model.state_dict(), True)["batch_stats"],
               jax.tree_util.tree_map(np.asarray, stats), "batch_stats", atol=1e-4)


def test_train_step_with_the_jax_mask_matches_jax(setup):
    s1, l1 = setup["step"]
    state = create_train_state(with_mask(setup["model"], setup["keep"]), lambda s: LR)
    losses_close(train_step(state, setup["crit"], torch.from_numpy(setup["x"])), l1, "losses")
    got = state_dict_to_variables(state.model.state_dict(), True)
    tree_close(got["batch_stats"], jax.tree_util.tree_map(np.asarray, s1.batch_stats), "batch_stats", atol=1e-4)
    adam = adam_of(s1.opt_state)
    mu, nu, count = port_moments(state.optimizer, True)
    assert count == int(adam.count) == 1
    want_mu, want_nu = (jax.tree_util.tree_map(np.asarray, t) for t in (adam.mu, adam.nu))
    tree_close(mu, want_mu, "mu", rel=1e-2)
    tree_close(nu, want_nu, "nu", rel=2e-2)
    eff_got, eff_want = (jax.tree_util.tree_map(lambda m: m / 0.1, t) for t in (mu, want_mu))
    params_close(got["params"], jax.tree_util.tree_map(np.asarray, s1.params), eff_got, eff_want, "params")


def test_the_ports_own_dropout_is_seeded_and_flax_shaped(setup):
    """Without the JAX mask the port draws its own from the train state's
    generator: the same seed gives the same step, the rate is 0.1, kept
    values are scaled by 1 / 0.9, and eval mode drops nothing."""
    runs = []
    for _ in range(2):
        state = create_train_state(copy.deepcopy(setup["model"]), lambda s: LR, seed=11)
        runs.append(train_step(state, setup["crit"], torch.from_numpy(setup["x"])))
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    drop = Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(64, 256, 4, 4))
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.01
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1.0 / 0.9]))
    assert torch.equal(drop.eval()(torch.ones(3)), torch.ones(3))
