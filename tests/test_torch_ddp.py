"""The data-parallel train step: 2 gloo ranks on the CPU against the port's
one-device step on the same global batch, and against the JAX package's
step over a 2-device mesh (``make_train_step(mesh=create_mesh(2))``).

The global batch is [8,32,32,3], each rank holding 4 rows. Its two halves
differ in brightness and in colour cast (bright and warm, dark and cool),
so every batch statistic of a rank's rows is far from the global batch's:
a step with per-rank BatchNorm statistics, per-rank exposure targets or
per-rank colour means (PyTorch's DDP on a per-rank loss) fails the bounds
below, and so does a gradient of the colour loss counted once per rank
(``test_wrong_reductions_fail_the_bounds`` builds both and prints how far
they land).

One launch of 2 ranks runs three steps, each from its own state: the
standard step and the packed step of the default net, and the standard
step of the pre-activation + ASPP net (its dropout drawn for the global
batch on every rank) with the frequency loss; the perceptual loss is on in
all three (the port's default VGG19). One JAX step is compiled, the
standard one.

Bounds. Against the port's one-device step (the same function up to the
order of its sums): the losses within rel 1e-5; Adam's first moment (0.1
of the clipped gradient) within 1e-3 of each leaf's largest magnitude
(floored at 1e-3 of the whole tree's, as tests/test_torch_train_step.py
floors it: a convolution's bias right before a BatchNorm has a gradient of
0, rounding noise on both sides, 1.8e-4 of its floor here); BatchNorm's running statistics within 1e-6; the parameters by
tests/test_parallel.py:58-72 (at most 2.1 lr apart, the 0.99 quantile
under 1e-4: a first Adam step moves a parameter by about lr times the sign
of its gradient, which the order of the sums flips where the gradient is
near 0). Against the JAX package's sharded step: the loss within rel 1e-4
and the parameters by the same rule, as tests/test_parallel.py holds its
own sharded step.
"""

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from retinex_tpu.config import Config as JConfig
from retinex_tpu.losses.total import LossState as JLossState
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.parallel.mesh import create_mesh as jax_create_mesh
from retinex_tpu.parallel.mesh import shard_batch as jax_shard_batch
from retinex_tpu.train.train_state import RetinexTrainState, make_optimizer, make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.losses.losses import color_loss
from retinex_tpu_torch.losses.total import LossConfig, TotalLoss
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.models.vgg import default_vgg
from retinex_tpu_torch.train.data_parallel import StepSpec, one_step, sharded_steps
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads

LR = 1e-3
MU_TOL = 1e-3  # Adam's first moment, over each leaf's scale
WITH_VGG = LossConfig(use_perceptual_loss=True)
SPECS = {
    "standard": StepSpec(lr=LR, loss=WITH_VGG),
    "packed": StepSpec(lr=LR, loss=WITH_VGG, packed=True),
    "aspp": StepSpec(use_preact=True, use_aspp=True, lr=LR, loss=LossConfig(use_perceptual_loss=True, use_freq_loss=True)),
}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def global_batch() -> np.ndarray:
    x = np.random.default_rng(7).random((8, 32, 32, 3), dtype=np.float32)
    x[:4] = 0.2 + 0.7 * x[:4] * np.array([1.0, 0.75, 0.45], np.float32)  # bright, warm
    x[4:] = 0.12 * x[4:] * np.array([0.45, 0.75, 1.0], np.float32)  # dark, cool
    return x


def weights(spec: StepSpec) -> dict:
    """Seeded weights with BatchNorm scales off 1 and drawn running
    statistics (so their update shows)."""
    model = init_untrained(MultiScaleUPRetinex(use_preact=spec.use_preact, use_aspp=spec.use_aspp), 0)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                t.copy_(torch.from_numpy(rng.uniform(0.2, 1.5, t.shape).astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs():
    """{name: (2-rank result, one-device result)}: one launch of 2 ranks."""
    batch = global_batch()
    names = list(SPECS)
    sds = [weights(SPECS[n]) for n in names]
    ranks = sharded_steps(2, [SPECS[n] for n in names], batch, device="cpu", state_dicts=sds)
    return {n: (r, one_step(SPECS[n], batch, "cpu", sd)) for n, r, sd in zip(names, ranks, sds)}


def _leaf_errors(got: dict, want: dict) -> dict:
    """|got - want| over each leaf's scale (its largest |want|, floored at
    1e-3 of the whole tree's)."""
    top = max(float(v.abs().max()) for v in want.values())
    return {k: float((got[k] - v).abs().max()) / max(float(v.abs().max()), 1e-3 * top) for k, v in want.items()}


def _param_diffs(got: dict, want: dict) -> np.ndarray:
    return np.concatenate([(got[k] - v).abs().reshape(-1).numpy() for k, v in want.items()])


def _hold_params(diffs: np.ndarray, what: str) -> None:
    assert diffs.max() <= 2.1 * LR, f"{what}: parameters {diffs.max():.3e} apart"
    assert np.quantile(diffs, 0.99) < 1e-4, f"{what}: 0.99 quantile {np.quantile(diffs, 0.99):.3e}"


@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_step_equals_one_device(runs, name):
    got, want = runs[name]
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, atol=1e-9, err_msg=f"{name} loss {k}")
    worst = max(_leaf_errors(got["mu"], want["mu"]).items(), key=lambda kv: kv[1])
    assert worst[1] < MU_TOL, f"{name}: Adam's first moment of {worst[0]} {worst[1]:.3e} of its scale apart"
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=0, atol=1e-6, err_msg=f"{name} {k}")
    _hold_params(_param_diffs(got["params"], want["params"]), name)


def _wrong_step(sd: dict, batch: np.ndarray, color_times: int = 1, per_rank: bool = False):
    """The step's losses and Adam moment as two mistaken data-parallel steps
    would take them, in one process: `per_rank`, each half's loss and
    statistics on its own and the gradients averaged (DDP on a per-rank
    loss); `color_times`, the global step with the colour loss's gradient
    counted that many times (an all-reduce whose backward sums it)."""
    model = MultiScaleUPRetinex(use_preact=False, use_aspp=False)
    model.load_state_dict(sd)
    state = create_train_state(model, lambda _s: LR, seed=0)
    crit = TotalLoss(WITH_VGG, vgg=default_vgg().eval())
    x = torch.from_numpy(batch)
    if per_rank:
        halves = [loss_and_grads(state, crit, x[i * 4 : (i + 1) * 4]) for i in range(2)]
        grads = {k: (halves[0][0][k] + halves[1][0][k]) / 2 for k in halves[0][0]}
        loss = {k: (float(halves[0][1][k]) + float(halves[1][1][k])) / 2 for k in halves[0][1]}
    else:
        out = model(x)
        grads, loss_dict, _ = loss_and_grads(state, crit, x)
        extra = torch.autograd.grad(crit.config.weight_col * color_loss(out[0]), list(state.optimizer.params.values()))
        grads = {k: g + (color_times - 1) * e for (k, g), e in zip(grads.items(), extra)}
        loss = {k: float(v) for k, v in loss_dict.items()}
    state.optimizer.step(grads)
    return loss, {k: v.clone() for k, v in state.optimizer.mu.items()}


def test_wrong_reductions_fail_the_bounds(runs):
    """The bounds above catch both mistakes the data-parallel step could
    make, on this batch: the numbers are printed."""
    got, want = runs["standard"]
    sd, batch = weights(SPECS["standard"]), global_batch()
    right = max(_leaf_errors(got["mu"], want["mu"]).values())
    loss_pr, mu_pr = _wrong_step(sd, batch, per_rank=True)
    per_rank = max(_leaf_errors(mu_pr, want["mu"]).values())
    loss_rel = abs(loss_pr["total"] - want["loss"]["total"]) / want["loss"]["total"]
    _, mu_2x = _wrong_step(sd, batch, color_times=2)
    twice = max(_leaf_errors(mu_2x, want["mu"]).values())
    print(
        f"Adam's first moment, the worst leaf's error over its scale: 2 ranks {right:.3e}; per-rank statistics "
        f"{per_rank:.3e} (total loss rel {loss_rel:.3e}); colour gradient counted twice {twice:.3e}"
    )
    assert right < MU_TOL
    assert per_rank > MU_TOL and loss_rel > 1e-5
    assert twice > MU_TOL


def test_sharded_step_holds_to_jax(runs, tmp_path):
    got, _ = runs["standard"]
    sd = weights(SPECS["standard"])
    npz = tmp_path / "vgg.npz"
    np.savez(npz, **{k: v.numpy() for k, v in default_vgg().state_dict().items()})
    variables = state_dict_to_variables(sd, False)
    state = RetinexTrainState.create(
        apply_fn=None,
        params=variables["params"],
        tx=make_optimizer(lambda s: LR),
        batch_stats=variables["batch_stats"],
        loss_state=JLossState.create(),
        dropout_rng=jax.random.PRNGKey(1),
    )
    mesh = jax_create_mesh(2)
    step = make_train_step(JNet(use_preact=False, use_aspp=False), jax_build_criterion(JConfig(vgg_weights=str(npz))),
                           mesh=mesh, donate=False)
    new, loss = step(state, jax_shard_batch(global_batch(), mesh))
    assert float(loss["total"]) == pytest.approx(got["loss"]["total"], rel=1e-4)
    mine = state_dict_to_variables({**sd, **got["params"]}, False)["params"]
    diffs = np.concatenate([
        np.abs(np.asarray(a) - np.asarray(b)).ravel()
        for a, b in zip(jtu.tree_leaves(mine), jtu.tree_leaves(new.params))
    ])
    assert jtu.tree_structure(mine) == jtu.tree_structure(new.params)
    _hold_params(diffs, "against the JAX package's sharded step")


@pytest.mark.parametrize("device,want", [(None, "cuda"), ("cuda:0", "cuda:0"), ("cpu", "cpu")])
def test_sharded_steps_runs_on_the_card_by_default(monkeypatch, device, want):
    """`device` None resolves to the card, as every entry point of the port;
    without one it raises before any rank starts."""
    from retinex_tpu_torch.train import data_parallel

    seen = []
    monkeypatch.setattr(data_parallel, "launch", lambda fn, args, config, world, backend: seen.append(config.device))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    data_parallel.sharded_steps(2, [SPECS["standard"]], np.zeros((2, 8, 8, 3), np.float32), device=device)
    assert seen == [want]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if want == "cpu":
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_parallel.sharded_steps(2, [SPECS["standard"]], np.zeros((2, 8, 8, 3), np.float32), device=device)
