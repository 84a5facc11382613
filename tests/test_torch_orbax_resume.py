"""A resume from a checkpoint the JAX package wrote mid-training: the port's
next step against the JAX package's next step, and ``--resume`` through the
port's CLI on one rank and on two.

The JAX package takes steps of ``make_train_step`` (``donate=False``) from
tests/test_torch_train_step.py's seeded net at [2,64,64,3], perceptual loss
on, and saves with its own ``save_checkpoint``: after two steps with
``grad_accum=1`` (Adam's moments and count 2, the DWA carry at step 2), and
after three micro-steps with ``grad_accum=2`` (one update applied, the
third micro-batch's gradient in MultiSteps' accumulator, mini-step 1). The
port's ``load_checkpoint`` restores each into a fresh train state of
another seed: everything it restores equals the JAX state bit for bit.
Then both take the next step on the same batch, held by
tests/test_torch_train_step.py's rules: losses rtol 1e-4 / atol 1e-5,
BatchNorm statistics atol 1e-4, Adam's moments at 1e-3 (mu) and 2e-3 (nu)
of the tree's largest magnitude: that file's rule for a batch where the
JAX package's f32 gradient is itself far from exact, as it is here. On the
plain run's next batch the JAX package's f32 gradient of
``ie_net.bottleneck1.bn1.bias`` (after the clip and the decay) sits 9.1 %
of that leaf's largest from the float64 value and the port's 2.5e-6 of it
(measured on the CPU; the JAX value read from Adam's first moment), which
breaks that file's per-leaf 1e-2 for a first step; so the port's own f32
gradient on that batch is held to its float64 gradient at the per-leaf
1e-2 (``test_the_resumed_gradient_matches_float64``, as that file's
``test_gradients_match_float64``). On the accumulated run's next batch it
is the port's f32 gradient of ``ie_net.dec2.conv2`` that sits 1.6 % of
that leaf's largest from float64 (measured), the f32 noise of that layer
which tests/test_torch_train_step.py's accumulated step meets too; there
the moments are held by the same tree-wide rule.
The parameters: both sides start from the same values and each moves by
lr times its Adam update, m_hat / (sqrt(v_hat) + 1e-8) of its own moments;
they are held to lr times the difference of the two updates, plus 1e-3 lr
and 1e-6 of the parameter for rounding (that file's ``params_close`` for
an Adam step past the first).

The CLI resumes the committed fixture (tests/test_torch_orbax.py) for one
epoch of two steps on one rank and on two (``parallel/distributed.launch``,
gloo), each from the fixture's epoch, the two runs' losses equal within
tests/test_torch_multihost.py's rel 1e-5; predict runs from the result.
"""

import copy
import csv
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.config import Config as JConfig
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import adam_state_to_optax, state_dict_to_variables
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.train.checkpoint import load_checkpoint
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads, train_step
from retinex_tpu_torch.train.trainer import build_criterion
from test_torch_orbax import FIXTURE, same_as_orbax
from test_torch_train_step import LR, adam_of, floor_of, jax_state, losses_close, port_model, save_vgg_npz, tree_close

import chip_smoke  # noqa: E402  (on the path through test_torch_orbax)

REPO = Path(__file__).resolve().parent.parent
SHAPE = (2, 64, 64, 3)
EPOCH, BEST = 1, 0.25
# (grad_accum, JAX steps taken before the save)
RUNS = ((1, 2), (2, 3))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{grad_accum: (checkpoint, the saved JAX state, the JAX state after
    the next step, its losses, the next batch)} and the port's criterion."""
    root = tmp_path_factory.mktemp("orbax_resume")
    model = port_model(False, False)
    npz = save_vgg_npz(root / "vgg19.npz")
    jnet = JNet(use_preact=False, use_aspp=False)
    jcrit = jax_build_criterion(JConfig(use_preact=False, use_aspp=False, vgg_weights=npz))
    rng = np.random.default_rng(9)
    xs = [rng.random(SHAPE, dtype=np.float32) * 0.6 for _ in range(4)]
    out = {}
    for accum, taken in RUNS:
        step = make_train_step(jnet, jcrit, donate=False)
        state = jax_state(model, accum, False)
        for x in xs[:taken]:
            state, _ = step(state, jnp.asarray(x))
        jax_save_checkpoint(state, str(root / f"accum{accum}"), EPOCH, BEST, is_best=False)
        after, losses = step(state, jnp.asarray(xs[taken]))
        out[accum] = (str(root / f"accum{accum}" / "latest"), state, after, losses, xs[taken])
    crit = build_criterion(Config(use_preact=False, use_aspp=False, vgg_weights=npz), torch.device("cpu"))
    return out, crit


def _np(tree):
    return jtu.tree_map(np.asarray, tree)


def adam_update(mu, nu, count):
    """optax's Adam direction m_hat / (sqrt(v_hat) + eps) at `count`."""
    bc1, bc2 = 1 - 0.9**count, 1 - 0.999**count
    return jtu.tree_map(lambda m, v: (np.asarray(m, np.float64) / bc1) / (np.sqrt(np.asarray(v, np.float64) / bc2) + 1e-8),
                        mu, nu)


def params_close_adam(got, want, u_got, u_want, what):
    def check(path, g, w, ug, uw):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        allowed = LR * (np.abs(ug - uw) + 1e-3) + 1e-6 * np.abs(w)
        bad = np.abs(g - w) > allowed
        assert not bad.any(), f"{what} {jtu.keystr(path)}: {int(bad.sum())} of {bad.size}, max {np.abs(g - w).max():.3e}"

    jtu.tree_map_with_path(check, got, want, u_got, u_want)


def _port_state(accum):
    """A train state of another seed than the JAX run's, to be overwritten."""
    return create_train_state(init_untrained(MultiScaleUPRetinex(False, False), 5), lambda s: LR, grad_accum=accum)


@pytest.mark.parametrize("accum", [a for a, _ in RUNS])
def test_load_checkpoint_restores_the_jax_state_exactly(runs, accum):
    path, saved, _, _, _ = runs[0][accum]
    state, epoch, best, extra = load_checkpoint(_port_state(accum), path)
    assert (epoch, best, extra, state.step) == (EPOCH + 1, BEST, {}, int(saved.step))
    got = state_dict_to_variables(state.model.state_dict(), use_aspp=False)
    n = same_as_orbax(got, _np({"params": saved.params, "batch_stats": saved.batch_stats}))
    adam = adam_of(saved.opt_state)
    mu, nu, count = adam_state_to_optax({"mu": state.optimizer.mu, "nu": state.optimizer.nu,
                                         "count": state.optimizer.count}, use_aspp=False)
    assert count == int(adam.count) == (2 if accum == 1 else 1) and n == 145 + 38
    assert same_as_orbax(mu, _np(adam.mu)) == same_as_orbax(nu, _np(adam.nu)) == 145
    assert float(np.abs(np.asarray(jtu.tree_leaves(adam.nu)[0])).max()) > 0
    for got_t, want_t in ((state.loss_state.prev, saved.loss_state.prev),
                          (state.loss_state.prev2, saved.loss_state.prev2), (state.loss_state.step, saved.loss_state.step)):
        assert same_as_orbax(got_t.numpy(), np.asarray(want_t)) == 1
    assert int(state.loss_state.step) == int(saved.step) and float(state.loss_state.prev.abs().max()) > 0
    if accum > 1:
        assert state.optimizer.mini_step == int(saved.opt_state.mini_step) == 1
        acc = state_dict_to_variables(state.optimizer.acc, use_aspp=False)["params"]
        assert same_as_orbax(acc, _np(saved.opt_state.acc_grads)) == 145
    key = np.asarray(saved.dropout_rng, np.uint32).tobytes()  # PRNGKey(1): a raw uint32 key
    assert torch.equal(state.dropout_gen.get_state(),
                       torch.Generator().manual_seed(int.from_bytes(key, "little")).get_state())


@pytest.mark.parametrize("accum", [a for a, _ in RUNS])
def test_the_next_step_after_the_resume_matches_jax(runs, accum):
    (path, saved, after, want_losses, x), crit = runs[0][accum], runs[1]
    state, _, _, _ = load_checkpoint(_port_state(accum), path)
    losses_close(train_step(state, crit, torch.from_numpy(x)), want_losses, f"the step after the resume ({accum})")
    assert state.step == int(after.step)
    got = state_dict_to_variables(state.model.state_dict(), use_aspp=False)
    tree_close(got["batch_stats"], _np(after.batch_stats), "batch_stats", atol=1e-4)
    adam = adam_of(after.opt_state)
    mu, nu, count = adam_state_to_optax({"mu": state.optimizer.mu, "nu": state.optimizer.nu,
                                         "count": state.optimizer.count}, use_aspp=False)
    want_mu, want_nu = _np(adam.mu), _np(adam.nu)
    assert count == int(adam.count) == 3 - (accum - 1)
    tree_close(mu, want_mu, "mu", atol=floor_of(want_mu))
    tree_close(nu, want_nu, "nu", atol=2 * floor_of(want_nu))
    if accum > 1:
        assert state.optimizer.mini_step == int(after.opt_state.mini_step) == 0
        assert all(not v.any() for v in state.optimizer.acc.values())
    params_close_adam(got["params"], _np(after.params), adam_update(mu, nu, count),
                      adam_update(want_mu, want_nu, count), "params")
    np.testing.assert_allclose(state.loss_state.prev.numpy(), np.asarray(after.loss_state.prev), rtol=1e-4, atol=1e-5)


def test_the_resumed_gradient_matches_float64(runs):
    """The port's f32 gradient on the plain run's next batch, from the
    restored state, against the same in float64 (net, losses, VGG and the
    restored values widened), per leaf at 1e-2 of the leaf's largest
    (floored at 1e-3 of the tree's, tests/test_torch_train_step.py's rule)."""
    accum = 1
    (path, _, _, _, x), crit = runs[0][accum], runs[1]
    g32, _, _ = loss_and_grads(load_checkpoint(_port_state(accum), path)[0], crit, torch.from_numpy(x))
    old = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        state = load_checkpoint(_port_state(accum), path)[0]
        state.model.double()
        crit64 = copy.deepcopy(crit)
        crit64.vgg.double()
        g64, _, _ = loss_and_grads(state, crit64, torch.from_numpy(x).double())
    finally:
        torch.set_default_dtype(old)
    want = state_dict_to_variables({k: v.float() for k, v in g64.items()}, use_aspp=False)["params"]
    tree_close(state_dict_to_variables(g32, use_aspp=False)["params"], want, "f32 vs f64", rel=1e-2)


def test_a_grad_accum_that_does_not_match_the_tree_raises(runs):
    with pytest.raises(ValueError, match="without gradient accumulation"):
        load_checkpoint(_port_state(2), runs[0][1][0])
    with pytest.raises(ValueError, match="with gradient accumulation"):
        load_checkpoint(_port_state(1), runs[0][2][0])


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(*args, cwd) -> str:
    out = subprocess.run([sys.executable, "-m", "retinex_tpu_torch.cli", *args], capture_output=True, text=True,
                         env=_env(), cwd=cwd, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_resumes_the_jax_checkpoint_on_one_rank_and_two(tmp_path):
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    for i in range(8):
        name = f"lowlight_{i:03d}.png"
        Image.open(REPO / "data" / "convergence" / name).convert("RGB").resize((48, 48)).save(train_dir / name)
    base = ["--mode", "train", "--train_dir", str(train_dir), "--image_size", "32", "--batch_size", "4",
            "--num_epochs", str(chip_smoke.ORBAX_FIXTURE_EPOCH + 2), "--no-use_perceptual_loss", "--no-progress_bar",
            "--device", "cpu", "--resume", str(FIXTURE)]
    one = _cli(*base, "--save_dir", str(tmp_path / "one"), cwd=tmp_path)
    two = _cli(*base, "--save_dir", str(tmp_path / "two"), "--n_devices", "2", cwd=tmp_path)
    start = chip_smoke.ORBAX_FIXTURE_EPOCH + 1
    for out in (one, two):
        assert f"Resumed from {FIXTURE} at epoch {start}" in out and out.count(f"Epoch {start}:") == 1
    assert "Data parallel: 2 rank(s)" in two
    for run in ("one", "two"):
        last = torch.load(tmp_path / run / "latest", map_location="cpu", weights_only=True)
        assert (last["step"], last["epoch"], last["optimizer"]["count"]) == (2, start, 2)

    def total(run):
        with open(tmp_path / run / "results.csv", newline="") as f:
            return float(next(csv.DictReader(f))["total"])

    assert total("two") == pytest.approx(total("one"), rel=1e-5)
    out = tmp_path / "pred"
    _cli("--mode", "predict", "--checkpoint", str(tmp_path / "one" / "latest"), "--input_path",
         str(train_dir / "lowlight_000.png"), "--output_dir", str(out), "--max_size", "64", "--device", "cpu",
         cwd=tmp_path)
    assert sorted(os.listdir(out)) == [f"lowlight_000_{k}.png" for k in ("comparison", "enhanced", "illumination")]
