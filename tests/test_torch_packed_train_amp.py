"""Packed bf16 training (``--packed_train --use_amp``): the port's packed
step with a bf16 net against the JAX package's
``make_train_step(MultiScaleUPRetinex(dtype=jnp.bfloat16), ..., packed=True,
donate=False)`` with ``use_amp`` VGG19, at [2,32,32,3], on the
pre-activation + ASPP net (tests/test_packed_train.py's bf16 net), the same
f32 weights and batches, perceptual loss on.

As tests/test_torch_amp_train.py does for the standard step: the JAX step
is compiled with ``lax.reduce_sum`` widening a bf16 operand to f32
(``f32_sums``: XLA's CPU backend sums a bf16 cotangent in bf16, PyTorch in
f32); it runs with ``grad_accum=2`` (after its first micro-step the
accumulator holds the raw gradient, the second applies Adam to the mean);
the dropout masks are read from the JAX standard train-mode forward with
the keys the two micro-steps draw (the packed forward calls the same
modules with the same keys, so it draws the same masks); and that file's
tolerances hold: losses rtol 2**-6 / atol 1e-5; BatchNorm statistics atol
4e-3, or by its noise rule where the JAX bf16 statistic is itself further
from the f32 step's (the ASPP fusion's running variance after the second
micro-step: the JAX bf16 step 8.3e-3 from the port's f32 packed step, the
port's bf16 step 6.0e-3, the two 5.4e-3 apart, measured); the gradient and
Adam's moments by its noise rule, all against the port's f32 packed step
on the same weights and masks; the parameters by
tests/test_torch_train_step.py's rule. Two JAX compiles: the step and the
forward that gives the masks.

The packed bf16 forward rounds where the JAX module rounds: the packed
kernels packed in f32, then rounded to bf16 by the convolution, whose sum
is rounded before its bias is added in bf16; the train-mode BatchNorm's
statistics in f32 of x widened once, its output rounded once; the FAM's
four fusion row blocks added in order, each add rounded.
"""

import copy

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from retinex_tpu.config import Config as JConfig
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads, train_step
from retinex_tpu_torch.train.trainer import build_criterion
from test_torch_amp_train import (
    NOISE_FACTOR,
    NOISE_FLOOR,
    STATS_ATOL,
    bf16_net,
    f32_sums,
    jax_masks,
    losses_close,
    noise_close,
    np_tree,
    with_masks,
)
from test_torch_train_step import LR, adam_of, batches, jax_state, params_close, port_model, port_moments, save_vgg_npz

PREACT, ASPP = True, True


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    npz = save_vgg_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    xs = batches(2, seed=27)
    model = port_model(PREACT, ASPP, seed=7)
    jnet = JNet(use_preact=PREACT, use_aspp=ASPP, dtype=jnp.bfloat16)
    jcfg = JConfig(use_preact=PREACT, use_aspp=ASPP, vgg_weights=npz, use_amp=True)
    with f32_sums():
        step = make_train_step(jnet, jax_build_criterion(jcfg), donate=False, packed=True)
        s0 = jax_state(model, 2, ASPP)
        s1, l1 = step(s0, jnp.asarray(xs[0]))
        s2, l2 = step(s1, jnp.asarray(xs[1]))
        # The keys the two micro-steps' forwards draw from (train_state.py:106).
        keys = [jax.random.fold_in(s.dropout_rng, s.step) for s in (s0, s1)]
        masks = jax_masks(jnet, (s0, s1), xs, keys)
    crit = build_criterion(Config(use_preact=PREACT, use_aspp=ASPP, vgg_weights=npz, use_amp=True),
                           torch.device("cpu"))
    return dict(model=model, xs=xs, crit=crit, masks=masks, steps=((s1, l1), (s2, l2)))


def port_state(s, grad_accum: int):
    return create_train_state(with_masks(bf16_net(s["model"]), s["masks"]), lambda step: LR, grad_accum=grad_accum)


def f32_packed_state(s, grad_accum: int):
    """The port's f32 net and VGG19 on the same weights, masks and batches,
    stepping packed: the reference of the noise rule."""
    net = with_masks(copy.deepcopy(s["model"]), s["masks"])
    crit = copy.deepcopy(s["crit"])
    for m in crit.vgg.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    return create_train_state(net, lambda step: LR, grad_accum=grad_accum), crit


def stats_close(got, want, f32, what):
    """Each statistic within STATS_ATOL of the JAX one, or, where the JAX
    bf16 statistic itself sits further from the f32 step's, within the
    noise rule (module docstring)."""
    top = max(float(np.abs(v).max()) for v in jtu.tree_leaves(f32))

    def check(path, g, w, t):
        tol = max(STATS_ATOL, NOISE_FACTOR * float(np.abs(w - t).max()) + NOISE_FLOOR * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} {jtu.keystr(path)}")

    jtu.tree_map_with_path(check, got, want, f32)


def test_losses_and_batch_stats_match_jax(setup):
    """Both micro-steps' losses and the BatchNorm statistics after each; the
    first micro-step leaves the parameters as they were."""
    s = setup
    state = port_state(s, 2)
    ref, crit = f32_packed_state(s, 2)
    before = {k: v.clone() for k, v in state.model.state_dict().items() if not k.endswith(("_mean", "_var", "_tracked"))}
    for i, (x, (js, jl)) in enumerate(zip(s["xs"], s["steps"])):
        losses_close(train_step(state, s["crit"], torch.from_numpy(x), packed=True), jl, f"micro-step {i + 1}")
        train_step(ref, crit, torch.from_numpy(x), packed=True)
        got, f32 = (state_dict_to_variables(st.model.state_dict(), ASPP)["batch_stats"] for st in (state, ref))
        stats_close(got, np_tree(js.batch_stats), f32, f"batch_stats {i + 1}")
        if i == 0:
            assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in before.items())


def test_packed_bf16_forward_computes_in_bf16(setup, monkeypatch):
    """Every convolution of the packed bf16 forward's own stages takes a
    bf16 input (each BatchNorm, add and attention rounds back to bf16); it
    returns f32 enhanced, reflectance and illumination (the f32 input's
    mean promotes them, as in JAX), and its f32 parameters receive f32
    gradients."""
    from retinex_tpu_torch.models import packed_train
    from retinex_tpu_torch.ops import s2d

    seen = []
    plain = s2d.conv_nhwc

    def recording(x, *args, **kwargs):
        seen.append(x.dtype)
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(s2d, "conv_nhwc", recording)
    monkeypatch.setattr(packed_train, "conv_nhwc", recording)
    net = with_masks(bf16_net(setup["model"]), setup["masks"][:1]).train()
    outs = packed_train.packed_train_apply(net, torch.from_numpy(setup["xs"][0]))
    # input 1, enc1 and enc2 3 each, dec2 and dec1 3 each, the residual head
    # 2, each packed tower 1 + 6 branch + 4 fusion + 2 attention + 1 SA,
    # the fusion head 2.
    assert seen == [torch.bfloat16] * 45
    assert [o.dtype for o in outs] == [torch.float32] * 3
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    sum(o.mean() for o in outs).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net.parameters())


def test_gradients_match_jax(setup):
    """The raw gradient of the first micro-step (optax's accumulator), f32
    on both sides, by the noise rule against the port's f32 packed step."""
    s = setup
    (s1, l1), _ = s["steps"]
    grads, loss_dict, _ = loss_and_grads(port_state(s, 1), s["crit"], torch.from_numpy(s["xs"][0]), packed=True)
    losses_close(loss_dict, l1, "losses")
    assert all(g.dtype == torch.float32 for g in grads.values())
    ref, crit = f32_packed_state(s, 1)
    g32, _, _ = loss_and_grads(ref, crit, torch.from_numpy(s["xs"][0]), packed=True)
    noise_close(state_dict_to_variables(grads, ASPP)["params"], np_tree(s1.opt_state.acc_grads),
                state_dict_to_variables(g32, ASPP)["params"], "gradients")


def test_adam_step_matches_jax(setup):
    """The second micro-step applies Adam to the mean of both gradients:
    the moments and the parameters after it, all f32."""
    s = setup
    _, (s2, _) = s["steps"]
    state = port_state(s, 2)
    for x in s["xs"]:
        train_step(state, s["crit"], torch.from_numpy(x), packed=True)
    assert state.optimizer.count == 1 and state.step == 2
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    ref, crit = f32_packed_state(s, 2)
    for x in s["xs"]:
        train_step(ref, crit, torch.from_numpy(x), packed=True)
    adam = adam_of(s2.opt_state)
    mu, nu, _ = port_moments(state.optimizer, ASPP)
    mu32, nu32, _ = port_moments(ref.optimizer, ASPP)
    want_mu, want_nu = np_tree(adam.mu), np_tree(adam.nu)
    noise_close(mu, want_mu, mu32, "mu")
    noise_close(nu, want_nu, nu32, "nu")
    eff_got, eff_want = (jtu.tree_map(lambda m: m / 0.1, t) for t in (mu, want_mu))
    got = state_dict_to_variables(state.model.state_dict(), ASPP)["params"]
    params_close(got, np_tree(s2.params), eff_got, eff_want, "params")
