"""Packed training (``models/packed_train.py``, ``--packed_train``) in f32
against the JAX package's ``packed_train_apply`` and the port's own
standard step, at [2,32,32,3] (tests/test_packed_train.py's shape), case by
case as that file holds the JAX module:

- the differentiable packers (``ops/s2d.pack_*_t``) equal the port's numpy
  packers and the JAX ``_t`` packers exactly, and carry the gradient back
  to every weight;
- the packed train-mode forward's outputs (atol 5e-4) and BatchNorm
  statistics (atol 1e-4) equal the JAX packed forward's, for every
  ``use_preact`` x ``use_aspp`` net; the ASPP nets' dropout draws the JAX
  forward's own mask (read from its Dropout's output, as
  tests/test_torch_train_step_aspp.py reads it);
- the gradients of tests/test_packed_train.py's loss equal ``jax.grad`` of
  the JAX packed loss within 1e-2 of each leaf's largest magnitude (floored
  at 1e-2), plus, for the ASPP nets, twice the JAX f32 gradient's own
  distance from the float64 gradient (the port's standard forward in
  float64, the same function up to rounding). The ASPP's pooled branch
  normalises 2 values a channel (batch 2 of a 1x1 map), which makes the f32
  gradient of the input layer ill-conditioned at this size: measured, both
  packages' f32 gradients sit up to 2.4 % of that leaf's largest from the
  float64 one, and the two part by up to 2.6 %, so 1e-2 alone would reject
  either package against the other; without the ASPP they agree within
  3e-6;
- the port's packed step equals its standard step (losses rtol 1e-4 / atol
  1e-5, BatchNorm statistics 1e-4, Adam's moments and the parameters by
  tests/test_torch_train_step.py's rules; the moments on the default net
  only: the ASPP net's f32 gradient is the ill-conditioned one above, its
  input layer's moments part by 1.2 %, and the gradient test holds it),
  the dropout generator drawn alike;
- ``--remat`` on the packed step: the gradients within 1e-5 of each leaf's
  largest (floored at 1e-3) of the plain packed step's, the outputs and
  the running statistics equal (updated once, not again by the
  recomputation);
- a packed step's checkpoint resumes in the trainer's standard step and
  the reverse; the trainer's gate is the JAX trainer's and gives its
  reasons.

The JAX side runs eagerly (no ``jax.jit``): after its primitives compile
for the first net, each further net takes seconds.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from retinex_tpu.models.packed_inference import _pack_convtranspose2 as jax_pack_convtranspose2
from retinex_tpu.models.packed_train import packed_train_apply as jax_packed_train_apply
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.ops import s2d as js
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models import layers
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.packed_inference import _pack_convtranspose2
from retinex_tpu_torch.models.packed_train import packed_train_apply
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import s2d as ts
from retinex_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads, train_step
from retinex_tpu_torch.train.trainer import build_criterion, train, use_packed_train
from test_torch_train_step import LR, losses_close, params_close, port_model, tree_close
from test_torch_trainer import _config, tiny_dataset  # noqa: F401 (a fixture)

SHAPE = (2, 32, 32, 3)
NETS = {"post_act": (False, False), "preact": (True, False), "aspp": (False, True), "preact_aspp": (True, True)}
OUT_ATOL, STATS_ATOL = 5e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def batch(seed=1):
    return np.random.default_rng(seed).random(SHAPE, np.float32) * 0.6


def probe_loss(enhanced, reflectance, illu):
    """tests/test_packed_train.py's gradient probe."""
    return (enhanced**2).mean() + illu.mean() + 0.1 * abs(reflectance).mean()


def jax_packed(model, use_preact, use_aspp, x, key):
    """The JAX packed forward and ``jax.grad`` of the probe loss, eagerly:
    (outputs, new batch_stats, gradients, the dropout's output or None)."""
    variables = state_dict_to_variables(model.state_dict(), use_aspp)
    jnet = JNet(use_preact=use_preact, use_aspp=use_aspp)
    seen = {}

    def intercept(call, args, kwargs, context):
        out = call(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            seen["dropped"] = out
        return out

    def loss(params):
        outs, stats = jax_packed_train_apply(jnet, params, variables["batch_stats"], jnp.asarray(x), key)
        dropped = jax.lax.stop_gradient(seen["dropped"]) if "dropped" in seen else None
        return probe_loss(outs[0], outs[1], outs[2]), (outs, stats, dropped)

    with fnn.intercept_methods(intercept):
        (_, (outs, stats, dropped)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    to_np = lambda t: jtu.tree_map(np.asarray, t)  # noqa: E731
    return to_np(outs), to_np(stats), to_np(grads), None if dropped is None else np.asarray(dropped)


def with_mask(model, dropped):
    """`model` whose dropout keeps where the JAX dropout's output is nonzero
    (where its input is 0 either choice gives 0), Flax's x / 0.9."""
    if dropped is None:
        return model
    keep = torch.from_numpy(dropped != 0).permute(0, 3, 1, 2)
    (drop,) = [m for m in model.modules() if isinstance(m, layers.Dropout)]
    drop.forward = lambda t: torch.where(keep, t / (1.0 - drop.p), torch.zeros_like(t))
    return model


def port_grads(model, x, packed=True):
    """The probe loss's gradients by the port's parameter names, and the outputs."""
    model.zero_grad()
    outs = packed_train_apply(model, x) if packed else model(x)
    probe_loss(*outs).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}, [o.detach() for o in outs]


@pytest.fixture(scope="module")
def runs():
    """Each net: the port's model (seeded weights, BatchNorm off identity),
    the batch, and the JAX packed forward and gradients."""
    x = batch()
    out = {}
    for name, (preact, aspp) in NETS.items():
        model = port_model(preact, aspp, seed=2)
        out[name] = dict(model=model, x=x, aspp=aspp, jax=jax_packed(model, preact, aspp, x, jax.random.PRNGKey(3)))
    return out


@pytest.mark.parametrize("case", ["s1_k3", "s1_k3_dilation2", "s1_k7", "s2_k3", "s2_k1", "pointwise", "convtranspose2"])
def test_packers_match_numpy_and_jax(case):
    """Each differentiable packer equals its numpy twin and the JAX ``_t``
    packer exactly; the gradient of the packed sum is the number of places
    each weight lands in (4 per quadrant copy, 1 for a stride-2 packing or
    a transposed conv's one quadrant)."""
    rng = np.random.default_rng(0)
    shapes = {"s1_k3": (3, 3, 5, 7), "s1_k3_dilation2": (3, 3, 5, 7), "s1_k7": (7, 7, 2, 1), "s2_k3": (3, 3, 5, 7),
              "s2_k1": (1, 1, 6, 4), "pointwise": (1, 1, 5, 7), "convtranspose2": (2, 2, 6, 4)}
    k = rng.standard_normal(shapes[case]).astype(np.float32)
    kt = torch.from_numpy(k).requires_grad_(True)
    if case.startswith("s1"):
        dil = 2 if "dilation2" in case else 1
        got, numpy, want, places = (ts.pack_kernel_s1_t(kt, dil), ts.pack_kernel_s1(k, dil),
                                    js.pack_kernel_s1_t(jnp.asarray(k), dilation=dil), 4)
    elif case.startswith("s2"):
        got, numpy, want, places = ts.pack_kernel_s2_t(kt), ts.pack_kernel_s2(k), js.pack_kernel_s2_t(jnp.asarray(k)), 1
    elif case == "pointwise":
        got, numpy, want, places = ts.pack_pointwise_t(kt), ts.pack_pointwise(k), js.pack_pointwise_t(jnp.asarray(k)), 4
    else:  # a Flax ConvTranspose kernel is PyTorch's weight [I,O,kh,kw] spatially flipped
        weight = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
        numpy = _pack_convtranspose2(weight)
        np.testing.assert_array_equal(numpy, np.asarray(jax_pack_convtranspose2(jnp.asarray(k))))
        got, want, places = ts.pack_convtranspose2_t(kt), js.pack_convtranspose2_t(jnp.asarray(k)), 1
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), numpy)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    assert torch.equal(kt.grad, torch.full_like(kt, float(places)))


@pytest.mark.parametrize("net", NETS)
def test_forward_and_batch_stats_match_jax(runs, net):
    r = runs[net]
    outs, stats, _, dropped = r["jax"]
    assert (dropped is not None) == r["aspp"]
    model = with_mask(copy.deepcopy(r["model"]), dropped).train()
    with torch.no_grad():
        got = packed_train_apply(model, torch.from_numpy(r["x"]))
    for name, g, w in zip(("enhanced", "reflectance", "illumination"), got, outs):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=OUT_ATOL, err_msg=name)
    tree_close(state_dict_to_variables(model.state_dict(), r["aspp"])["batch_stats"], stats, "batch_stats",
               atol=STATS_ATOL)


def float64_grads(model, x, dropped, use_aspp):
    """The probe loss's gradients through the port's standard forward in
    float64 (the exact function's, to f32 rounding), Flax names."""
    m64 = with_mask(copy.deepcopy(model).double().train(), dropped)
    grads, _ = port_grads(m64, torch.from_numpy(x).double(), packed=False)
    return state_dict_to_variables({k: g.float() for k, g in grads.items()}, use_aspp)["params"]


@pytest.mark.parametrize("net", NETS)
def test_gradients_match_jax(runs, net):
    """Module docstring: 1e-2 of each leaf's largest magnitude (floored at
    1e-2), plus, with the ASPP, twice the JAX f32 leaf's distance from the
    float64 gradient."""
    r = runs[net]
    _, _, want, dropped = r["jax"]
    model = with_mask(copy.deepcopy(r["model"]), dropped).train()
    grads, _ = port_grads(model, torch.from_numpy(r["x"]))
    got = state_dict_to_variables(grads, r["aspp"])["params"]
    exact = float64_grads(r["model"], r["x"], dropped, r["aspp"]) if r["aspp"] else None
    assert jtu.tree_structure(got) == jtu.tree_structure(want)
    noise = jtu.tree_map(lambda w, t: float(np.abs(w - t).max()), want, exact) if exact else None
    flat_noise = dict(jtu.tree_leaves_with_path(noise)) if noise else {}

    def check(path, g, w):
        tol = 1e-2 * max(float(np.abs(w).max()), 1e-2) + 2.0 * flat_noise.get(path, 0.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=jtu.keystr(path))

    jtu.tree_map_with_path(check, got, want)


@pytest.mark.parametrize("net", ["post_act", "preact_aspp"])
def test_packed_step_matches_the_standard_step(net):
    """One step each from one state and batch, perceptual loss on (as
    tests/test_packed_train.py's step test), and a second packed step."""
    preact, aspp = NETS[net]
    model = port_model(preact, aspp, seed=6)
    crit = build_criterion(Config(use_preact=preact, use_aspp=aspp), torch.device("cpu"))
    x = torch.from_numpy(batch(seed=5))
    states, losses = {}, {}
    for packed in (False, True):
        states[packed] = create_train_state(copy.deepcopy(model), lambda s: LR, seed=11)
        losses[packed] = train_step(states[packed], crit, x, packed=packed)
    losses_close(losses[True], losses[False], "packed vs standard")
    std, pk = (state_dict_to_variables(states[p].model.state_dict(), aspp) for p in (False, True))
    tree_close(pk["batch_stats"], std["batch_stats"], "batch_stats", atol=STATS_ATOL)
    mu, nu = ({p: state_dict_to_variables(getattr(states[p].optimizer, m), aspp)["params"] for p in (False, True)}
              for m in ("mu", "nu"))
    if not aspp:  # the ASPP net's gradient is ill-conditioned (module docstring)
        tree_close(mu[True], mu[False], "mu", rel=1e-2)
        tree_close(nu[True], nu[False], "nu", rel=2e-2)
    eff = {p: jtu.tree_map(lambda m: m / 0.1, mu[p]) for p in (False, True)}
    params_close(pk["params"], std["params"], eff[True], eff[False], "params")
    # The ASPP's dropout drew alike from the two states' generators.
    assert torch.equal(states[True].dropout_gen.get_state(), states[False].dropout_gen.get_state())
    again = train_step(states[True], crit, x, packed=True)
    assert states[True].step == 2 and all(bool(torch.isfinite(v)) for v in again.values())


def test_remat_packed_gradients_match_the_packed_gradients():
    """``remat=True`` checkpoints the six packed stages: the same gradients
    (1e-5 of each leaf's largest, floored at 1e-3), outputs, and running
    statistics, which the recomputation leaves as they are."""
    model = port_model(True, True, seed=8)
    x = torch.from_numpy(batch(seed=9))
    grads, outs, stats = {}, {}, {}
    for remat in (False, True):
        net = MultiScaleUPRetinex(True, True, remat=remat)
        net.load_state_dict(model.state_dict())
        create_train_state(net, lambda s: LR, seed=3)  # the dropout's generator, seeded alike
        grads[remat], outs[remat] = port_grads(net, x)
        stats[remat] = {k: v.clone() for k, v in net.state_dict().items() if k.endswith(("_mean", "_var"))}
    assert not layers.recomputing()
    for k, g in grads[False].items():
        scale = max(float(g.abs().max()), 1e-3)
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), rtol=0, atol=1e-5 * scale, err_msg=k)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    for k, v in stats[False].items():
        np.testing.assert_allclose(stats[True][k].numpy(), v.numpy(), rtol=0, atol=5e-6, err_msg=k)
    moved = [k for k, v in stats[False].items() if not torch.equal(v, model.state_dict()[k])]
    assert len(moved) == len(stats[False])


def test_remat_stages_recompute_without_a_second_statistics_update(monkeypatch):
    """Under ``--remat`` the packed stages' BatchNorms run again in the
    backward, flagged by ``recomputing()``, and update nothing then."""
    model = port_model(False, False, seed=10)
    net = MultiScaleUPRetinex(False, False, remat=True)
    net.load_state_dict(model.state_dict())
    from retinex_tpu_torch.models import packed_train as pt

    seen = []
    plain = pt._bn_train
    monkeypatch.setattr(pt, "_bn_train", lambda x, bn, phases=1: seen.append(layers.recomputing()) or plain(x, bn, phases))
    port_grads(net.train(), torch.from_numpy(batch(seed=12)))
    # enc1 3 + enc2 3 + dec2 2 + dec1 2 BatchNorms, once forward and once recomputed.
    assert seen.count(False) == 10 and seen.count(True) == 10


def test_a_packed_checkpoint_resumes_in_the_standard_trainer_and_back(tiny_dataset, tmp_path, capsys):  # noqa: F811
    """A packed step's state saves in the standard format; the trainer (on
    the CPU, so the standard step, saying why) resumes from it; a standard
    run's checkpoint loads and takes a packed step."""
    cfg = _config(tiny_dataset, tmp_path / "run", num_epochs=1, use_perceptual_loss=False)
    crit = build_criterion(cfg, torch.device("cpu"))
    state = create_train_state(port_model(False, False, seed=13), lambda s: LR)
    train_step(state, crit, torch.from_numpy(batch(seed=14)), packed=True)
    save_checkpoint(state, cfg.save_dir, epoch=0, best_loss=1.0, is_best=True)
    result = train(_config(tiny_dataset, tmp_path / "run", num_epochs=2, use_perceptual_loss=False,
                           resume=str(tmp_path / "run" / "latest")))
    out = capsys.readouterr().out
    assert "packed_train: CPU backend, using the standard step" in out and "Resumed from" in out
    assert result["epochs_run"] == 2
    back = create_train_state(port_model(False, False, seed=15), lambda s: LR)
    back, start, _, _ = load_checkpoint(back, str(tmp_path / "run" / "latest"))
    assert start == 2 and back.step == 1 + 2
    losses = train_step(back, crit, torch.from_numpy(batch(seed=16)), packed=True)
    assert back.step == 4 and all(bool(torch.isfinite(v)) for v in losses.values())


@pytest.mark.parametrize(
    "flags, device, want, message",
    [
        (dict(), "cpu", False, "packed_train: CPU backend, using the standard step"),
        (dict(), "cuda", True, "packed_train: the s2d-packed train step"),
        (dict(image_size=100), "cuda", False, "packed_train: image_size not divisible by 32, using the standard step"),
        (dict(packed_train=False), "cuda", False, ""),
    ],
)
def test_the_trainers_gate_is_the_jax_trainers(flags, device, want, message, capsys):
    """The packed step on the card at a multiple of 32 with --packed_train
    (the default); the JAX package's reason where the flag is on and the
    step is the standard one."""
    assert use_packed_train(Config(mode="train", **flags), torch.device(device)) is want
    assert capsys.readouterr().out.strip() == message


def test_loss_and_grads_takes_the_packed_forward(runs):
    """``loss_and_grads(packed=True)`` differentiates the packed forward:
    its gradients differ from the standard forward's by rounding only."""
    r = runs["post_act"]
    crit = build_criterion(Config(use_perceptual_loss=False), torch.device("cpu"))
    got = {}
    for packed in (False, True):
        state = create_train_state(copy.deepcopy(r["model"]), lambda s: LR)
        got[packed], _, _ = loss_and_grads(state, crit, torch.from_numpy(r["x"]), packed=packed)
    tree_close(state_dict_to_variables(got[True], False)["params"],
               state_dict_to_variables(got[False], False)["params"], "gradients", rel=1e-4)
