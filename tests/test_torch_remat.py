"""``--remat``: the port's net with ``remat=True`` checkpoints (recomputes in
the backward) what the JAX net wraps in ``nn.remat``: the IE-net's residual
or pre-activation blocks and UpBlocks, and the three scale towers; not the
ASPP, whose dropout would draw a second mask on a recomputation.

- The remat step equals the plain step, on the default net and on the
  pre-activation + ASPP net (whose dropout draws from the train state's
  generator), at tests/test_remat.py's tolerances: the total loss rtol
  1e-6, the parameters after Adam within 2.1 lr and 99.9 % of them within
  1e-5, the BatchNorm statistics atol 5e-6 (on the CPU they are in fact
  identical: the recomputation runs the same operations on the same
  values). The statistics are updated once: the recomputation runs
  ``BatchNorm.forward`` again, and ``models/layers.recomputing()`` keeps it
  from folding the batch statistics in a second time.
- The dropout generator is drawn once per step with remat as without it
  (the ASPP is not recomputed), so the masks, and the steps after, agree.
- The parameter names do not change (a remat run's checkpoint loads into a
  plain net and back).
- The port's remat step against the JAX package's ``remat=True`` step
  (``make_train_step(MultiScaleUPRetinex(remat=True), ..., donate=False)``,
  one compile) on the default net at [2,32,32,3] without the perceptual
  loss, as tests/test_remat.py runs it, at tests/test_torch_train_step.py's
  tolerances: losses rtol 1e-4 / atol 1e-5, BatchNorm statistics atol 1e-4,
  Adam's moments 1e-2 (first) and 2e-2 (second) of each leaf's largest
  magnitude (floored at 1e-3 of the tree's), the parameters by its rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.losses.total import LossConfig as JLossConfig
from retinex_tpu.losses.total import TotalLoss as JTotalLoss
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu_torch.losses.total import LossConfig, TotalLoss
from retinex_tpu_torch.models import layers
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.train.train_state import create_train_state, train_step
from test_torch_train_step import (
    LR,
    adam_of,
    batches,
    jax_state,
    losses_close,
    params_close,
    port_model,
    port_moments,
    tree_close,
)

NETS = {"post_act": (False, False), "preact_aspp": (True, True)}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def criterion():
    return TotalLoss(LossConfig(use_perceptual_loss=False, use_freq_loss=False))


def remat_net(model, remat=True):
    """The port's net with `model`'s weights and statistics, remat on or off."""
    net = MultiScaleUPRetinex(model.use_preact, model.use_aspp, remat=remat)
    net.load_state_dict(model.state_dict())
    return net


def run_steps(model, remat, xs, seed=7):
    state = create_train_state(remat_net(model, remat), lambda s: LR, seed=seed)
    losses = [train_step(state, criterion(), torch.from_numpy(x)) for x in xs]
    return state, losses


@pytest.mark.parametrize("net", NETS)
def test_remat_step_equals_the_plain_step(net):
    model = port_model(*NETS[net], seed=4)
    xs = batches(2, seed=19)
    (plain, l_plain), (remat, l_remat) = run_steps(model, False, xs), run_steps(model, True, xs)
    for a, b in zip(l_plain, l_remat):
        np.testing.assert_allclose(float(b["total"]), float(a["total"]), rtol=1e-6)
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    sd_p, sd_r = plain.model.state_dict(), remat.model.state_dict()
    assert sd_p.keys() == sd_r.keys()
    diffs = np.concatenate([(sd_r[k] - sd_p[k]).abs().flatten().numpy() for k, _ in plain.model.named_parameters()])
    assert diffs.max() <= 2.1 * LR and np.quantile(diffs, 0.999) < 1e-5
    for k in sd_p:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd_r[k].numpy(), sd_p[k].numpy(), rtol=0, atol=5e-6, err_msg=k)
    # The ASPP's dropout drew the same masks: its generator stands where the plain run's does.
    assert torch.equal(plain.dropout_gen.get_state(), remat.dropout_gen.get_state())


def test_remat_gradients_equal_the_plain_gradients():
    """One backward with remat and without, on the ASPP net: every
    parameter's gradient within test_remat.py's bound of 1e-5, and the
    running statistics folded in once."""
    model = port_model(True, True, seed=5)
    x = torch.from_numpy(batches(1, seed=21)[0])
    grads, stats = {}, {}
    for remat in (False, True):
        state = create_train_state(remat_net(model, remat), lambda s: LR, seed=3)
        enh, refl, illu = state.model(x)
        total, _, _ = criterion()(x, enh, illu, refl, state.loss_state)
        total.backward()
        grads[remat] = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        stats[remat] = {k: v.clone() for k, v in state.model.state_dict().items() if k.endswith(("_mean", "_var"))}
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), rtol=0, atol=1e-5, err_msg=k)
    for k, v in stats[False].items():
        np.testing.assert_allclose(stats[True][k].numpy(), v.numpy(), rtol=0, atol=5e-6, err_msg=k)


def test_a_recomputed_batchnorm_updates_its_statistics_once():
    """A train-mode BatchNorm under ``checkpointed``: the forward folds the
    batch statistics in, the backward's recomputation runs the forward again
    (under ``recomputing()``) and leaves them as they are; its output and
    gradients equal the plain module's."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 5)).astype(np.float32))
    mods, outs, seen = [], [], []
    for remat in (False, True):
        bn = layers.BatchNorm(8).train()
        forward = bn.forward
        bn.forward = lambda t, f=forward: seen.append((remat, layers.recomputing())) or f(t)
        xx = x.clone().requires_grad_(True)
        y = layers.checkpointed(bn, remat, xx)
        (y * y).sum().backward()
        mods.append(bn)
        outs.append((y.detach(), xx.grad, bn.weight.grad))
    assert seen == [(False, False), (True, False), (True, True)]  # the recomputation ran, flagged
    assert not layers.recomputing()
    want_mean = 0.1 * x.mean(dim=(0, 2, 3))
    for bn in mods:
        torch.testing.assert_close(bn.running_mean, want_mean, rtol=1e-6, atol=1e-7)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # Off training, or without remat, checkpointed is the module's own call.
    bn = layers.BatchNorm(8).eval()
    assert torch.equal(layers.checkpointed(bn, True, x), bn(x))


def test_remat_keeps_the_parameter_names_and_the_eval_forward():
    model = port_model(True, True, seed=8)
    remat = remat_net(model)
    assert list(remat.state_dict()) == list(model.state_dict())
    x = torch.from_numpy(batches(1, seed=23)[0])
    with torch.no_grad():
        for a, b in zip(remat.eval()(x), model.eval()(x)):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_remat_step():
    model = port_model(False, False, seed=9)
    x = batches(1, seed=25)[0]
    jcrit = JTotalLoss(JLossConfig(use_perceptual_loss=False, use_freq_loss=False), vgg_apply=None)
    step = make_train_step(JNet(use_preact=False, use_aspp=False, remat=True), jcrit, donate=False)
    s1, l1 = step(jax_state(model, 1, False), jnp.asarray(x))
    return model, x, s1, l1


def test_remat_step_matches_the_jax_remat_step(jax_remat_step):
    model, x, s1, l1 = jax_remat_step
    state = create_train_state(remat_net(model), lambda s: LR)
    losses_close(train_step(state, criterion(), torch.from_numpy(x)), l1, "losses")
    got = state_dict_to_variables(state.model.state_dict(), False)
    tree_close(got["batch_stats"], jax.tree_util.tree_map(np.asarray, s1.batch_stats), "batch_stats", atol=1e-4)
    adam = adam_of(s1.opt_state)
    mu, nu, count = port_moments(state.optimizer, False)
    assert count == int(adam.count) == 1
    want_mu, want_nu = (jax.tree_util.tree_map(np.asarray, t) for t in (adam.mu, adam.nu))
    tree_close(mu, want_mu, "mu", rel=1e-2)
    tree_close(nu, want_nu, "nu", rel=2e-2)
    eff_got, eff_want = (jax.tree_util.tree_map(lambda m: m / 0.1, t) for t in (mu, want_mu))
    params_close(got["params"], jax.tree_util.tree_map(np.asarray, s1.params), eff_got, eff_want, "params")
