"""bf16 training (``--use_amp --mode train``): the port's train step against
the JAX package's ``make_train_step(MultiScaleUPRetinex(dtype=jnp.bfloat16),
..., donate=False)`` with ``use_amp`` VGG19, at [2,32,32,3], on the default
net and on the pre-activation + ASPP net (whose dropout mask is read from
the JAX forward and given to the port, as tests/test_torch_train_step_aspp.py
does), the same f32 weights and batches, perceptual loss on; and the
train-mode BatchNorm in bf16 alone against ``flax.linen.BatchNorm(dtype=bf16)``.

One JAX step is compiled per net (``grad_accum=2``, ``optax.MultiSteps``:
after its first micro-step the accumulator holds the raw gradient and the
parameters are unchanged; the second applies Adam to the mean gradient), and
for the ASPP net one train-mode forward for the masks.

**XLA's CPU reduce of a bf16 array accumulates in bf16.** ``jnp.sum`` and
``jnp.mean`` widen bf16 to f32 first, but the reductions that autodiff
writes (the transpose of a broadcast: a bias's gradient, the channel
attention's) call ``lax.reduce_sum`` on the bf16 cotangent, and XLA's CPU
backend sums it in bf16: 6144 values of 1/6144 sum to 0.0625, not 1/3
(``test_xla_cpu_sums_a_bf16_cotangent_in_bf16``). The JAX package's bf16
gradient on the CPU is then far from its own f32 gradient (the output
layer's bias gradient 0.016 against 0.084 for the mean of the enhanced
image). PyTorch sums a bf16 tensor in f32 and rounds once, on the CPU and
on the card, so the port's bf16 gradient stays within a few 1e-3 of its f32
gradient. The JAX step here is therefore compiled with ``lax.reduce_sum``
widening a bf16 operand to f32 and rounding the sum once (``f32_sums``,
for this module's JAX calls only): the sum ``jnp.sum`` computes; the JAX
package is not edited. With that, its bf16 gradient parts from its f32
gradient as the port's does (ROADMAP, "Divergences inside the JAX package").

Tolerances (bf16: 8 bits of mantissa, one ulp 2**-8 to 2**-7 relative;
every convolution, bias add and activation of the net and VGG19 rounds to
bf16 on both sides, and the two sum their f32 products in other orders, so
a value rounds the other way now and then and the flips add up through the
net and back):

- losses rtol 2**-6 (two bf16 ulps: the perceptual loss is a bf16 sum of
  three bf16 means, each within one ulp), atol 1e-5 (the colour loss, a
  square of small differences of means, ~1e-4);
- BatchNorm running statistics atol 4e-3 (0.1 of the batch statistics,
  which are f32 means of bf16 activations that part by an ulp here and
  there; seen 1.5e-3 on the bottleneck's variances);
- the raw gradient, and Adam's first and second moments after the step,
  against bf16 rounding noise, measured: the same step in f32 (the port's,
  which tests/test_torch_train_step.py holds to the JAX package's f32 step)
  gives each leaf's reference t, and the port's bf16 leaf p must lie
  within three times the JAX bf16 leaf j's own distance from it, plus 2e-3
  of the tree's largest magnitude: max |p - j| <= 3 max |j - t| + 2e-3
  max |t|. Rounding noise in a bf16 backward scales with the cotangents
  that flow through a layer, not with the leaf's own gradient: the input
  layer's bias gradient, at the end of the backward, sits 8e-3 (default
  net) and 6e-2 (pre-activation + ASPP) of the largest gradient from the
  f32 one on the JAX side, 8e-3 and 9e-2 on the port's, and the two bf16
  gradients part by 9e-3 and 5e-2 (seen); with both sides' noise of one
  size, |p - j| <= |p - t| + |j - t| stays under about twice |j - t|. The
  rule also bounds the port's own noise, |p - t| <= 4 |j - t| + 2e-3;
- the parameters after Adam by tests/test_torch_train_step.py's rule:
  each side moves a parameter by lr times the sign-like Adam update of its
  own gradient, so the two may part by lr times the difference of those
  two updates (up to 2 lr where the gradient is near 0 and its sign
  parts), plus 1e-3 lr and 1e-6 of the parameter;
- the BatchNorm alone: its output within one bf16 ulp (rtol 2**-7, atol
  2**-10), its running statistics and its parameters' gradients (f32,
  from f32 sums in other orders) within 1e-6 and rtol 1e-4, its input's
  gradient (bf16) within one ulp.
"""

import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax._src.lax import lax as jax_lax

from retinex_tpu.config import Config as JConfig
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.layers import BatchNorm, Dropout
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.train.train_state import create_train_state, loss_and_grads, train_step
from retinex_tpu_torch.train.trainer import build_criterion
from test_torch_train_step import LR, adam_of, batches, jax_state, params_close, port_model, port_moments, save_vgg_npz

BF16 = torch.bfloat16
NETS = {"post_act": (False, False), "preact_aspp": (True, True)}
LOSS_RTOL, LOSS_ATOL = 2.0**-6, 1e-5
STATS_ATOL = 4e-3
NOISE_FACTOR, NOISE_FLOOR = 3.0, 2e-3


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@contextlib.contextmanager
def f32_sums():
    """``lax.reduce_sum`` of a bf16 operand summed in f32 and rounded once
    (module docstring), while JAX traces inside."""
    plain = jax_lax.reduce_sum

    def widened(operand, axes, *args, **kwargs):
        if operand.dtype == jnp.bfloat16:
            return plain(operand.astype(jnp.float32), axes, *args, **kwargs).astype(jnp.bfloat16)
        return plain(operand, axes, *args, **kwargs)

    jax_lax.reduce_sum = widened
    try:
        yield
    finally:
        jax_lax.reduce_sum = plain


def bf16_net(model):
    """The port's net computing in bf16 with `model`'s f32 parameters."""
    net = MultiScaleUPRetinex(model.use_preact, model.use_aspp, dtype=BF16)
    net.load_state_dict(model.state_dict())
    return net


def with_masks(model, masks):
    """`model` whose dropout draws the given keep masks in turn (Flax's
    rule: x / 0.9 where kept)."""
    (drop,) = [m for m in model.modules() if isinstance(m, Dropout)]
    queue = list(masks)
    drop.forward = lambda t: torch.where(queue.pop(0), t / (1.0 - drop.p), torch.zeros_like(t))
    return model


def jax_masks(jnet, state, xs, keys):
    """The JAX train-mode forward's dropout keep masks (NCHW), one per
    (state, batch, key); where the dropout's input is 0 either choice gives 0."""
    fwd = jax.jit(lambda v, x, k: jnet.apply(v, x, train=True, mutable=["batch_stats", "intermediates"],
                                            capture_intermediates=True, rngs={"dropout": k}))
    out = []
    for st, x, key in zip(state, xs, keys):
        _, upd = fwd({"params": st.params, "batch_stats": st.batch_stats}, jnp.asarray(x), key)
        dropped = np.asarray(upd["intermediates"]["ie_net"]["aspp"]["Dropout_0"]["__call__"][0].astype(jnp.float32))
        out.append(torch.from_numpy(dropped != 0).permute(0, 3, 1, 2))
    return out


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    npz = save_vgg_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    xs = batches(2, seed=17)
    out = {}
    for name, (preact, aspp) in NETS.items():
        model = port_model(preact, aspp, seed=3)
        jnet = JNet(use_preact=preact, use_aspp=aspp, dtype=jnp.bfloat16)
        with f32_sums():
            step = make_train_step(jnet, jax_build_criterion(JConfig(use_preact=preact, use_aspp=aspp,
                                                                       vgg_weights=npz, use_amp=True)), donate=False)
            s0 = jax_state(model, 2, aspp)
            s1, l1 = step(s0, jnp.asarray(xs[0]))
            s2, l2 = step(s1, jnp.asarray(xs[1]))
            masks = None
            if aspp:  # the keys the two micro-steps' forwards draw from (train_state.py:106)
                keys = [jax.random.fold_in(s.dropout_rng, s.step) for s in (s0, s1)]
                masks = jax_masks(jnet, (s0, s1), xs, keys)
        crit = build_criterion(Config(use_preact=preact, use_aspp=aspp, vgg_weights=npz, use_amp=True),
                               torch.device("cpu"))
        out[name] = dict(model=model, aspp=aspp, xs=xs, crit=crit, masks=masks, steps=((s1, l1), (s2, l2)))
    return out


def port_net(setup):
    net = bf16_net(setup["model"])
    return with_masks(net, setup["masks"]) if setup["masks"] is not None else net


def np_tree(t):
    return jtu.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), t)


def losses_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=f"{what}: {k}")


def stats_close(got, want, what):
    def check(path, g, w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=STATS_ATOL, err_msg=f"{what} {jtu.keystr(path)}")

    jtu.tree_map_with_path(check, got, want)


def noise_close(got, want, f32, what):
    """Leaf by leaf, the port's bf16 `got` within NOISE_FACTOR times the JAX
    bf16 `want`'s distance from the f32 reference `f32`, plus NOISE_FLOOR of
    the reference's largest magnitude (module docstring)."""
    assert jtu.tree_structure(got) == jtu.tree_structure(want) == jtu.tree_structure(f32), what
    top = max(float(np.abs(np.asarray(v)).max()) for v in jtu.tree_leaves(f32))

    def check(path, g, w, t):
        g, w, t = (np.asarray(a, np.float64) for a in (g, w, t))
        tol = NOISE_FACTOR * float(np.abs(w - t).max()) + NOISE_FLOOR * top
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} {jtu.keystr(path)}")

    jtu.tree_map_with_path(check, got, want, f32)


def f32_step(setup, grad_accum: int):
    """The port's f32 net on the same weights, masks and batches: the
    reference of the noise rule."""
    net = copy.deepcopy(setup["model"])
    net = with_masks(net, setup["masks"]) if setup["masks"] is not None else net
    crit = copy.deepcopy(setup["crit"])
    for m in crit.vgg.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    return create_train_state(net, lambda step: LR, grad_accum=grad_accum), crit


@pytest.mark.parametrize("net", NETS)
def test_losses_and_batch_stats_match_jax(setups, net):
    """Both micro-steps' losses and the BatchNorm statistics after each;
    the first micro-step leaves the parameters as they were."""
    s = setups[net]
    (s1, l1), (s2, l2) = s["steps"]
    state = create_train_state(port_net(s), lambda step: LR, grad_accum=2)
    before = {k: v.clone() for k, v in state.model.state_dict().items() if not k.endswith(("_mean", "_var", "_tracked"))}
    losses_close(train_step(state, s["crit"], torch.from_numpy(s["xs"][0])), l1, "micro-step 1")
    got = state_dict_to_variables(state.model.state_dict(), s["aspp"])
    stats_close(got["batch_stats"], np_tree(s1.batch_stats), "batch_stats 1")
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in before.items())
    losses_close(train_step(state, s["crit"], torch.from_numpy(s["xs"][1])), l2, "micro-step 2")
    got = state_dict_to_variables(state.model.state_dict(), s["aspp"])
    stats_close(got["batch_stats"], np_tree(s2.batch_stats), "batch_stats 2")


@pytest.mark.parametrize("net", NETS)
def test_gradients_match_jax(setups, net):
    """The raw gradient of the first micro-step (optax's accumulator), in
    f32 on both sides (the parameters are f32; each gradient flows back
    through the bf16 casts)."""
    s = setups[net]
    (s1, l1), _ = s["steps"]
    state = create_train_state(port_net(s), lambda step: LR)
    grads, loss_dict, _ = loss_and_grads(state, s["crit"], torch.from_numpy(s["xs"][0]))
    losses_close(loss_dict, l1, "losses")
    assert all(g.dtype == torch.float32 for g in grads.values())
    ref, crit = f32_step(s, 1)
    g32, _, _ = loss_and_grads(ref, crit, torch.from_numpy(s["xs"][0]))
    noise_close(state_dict_to_variables(grads, s["aspp"])["params"], np_tree(s1.opt_state.acc_grads),
                state_dict_to_variables(g32, s["aspp"])["params"], "gradients")


@pytest.mark.parametrize("net", NETS)
def test_adam_step_matches_jax(setups, net):
    """The second micro-step applies Adam to the mean of both gradients:
    the moments and the parameters after it, all f32."""
    s = setups[net]
    _, (s2, _) = s["steps"]
    state = create_train_state(port_net(s), lambda step: LR, grad_accum=2)
    for x in s["xs"]:
        train_step(state, s["crit"], torch.from_numpy(x))
    assert state.optimizer.count == 1 and state.step == 2
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(m.dtype == torch.float32 for m in (*state.optimizer.mu.values(), *state.optimizer.nu.values()))
    ref, crit = f32_step(s, 2)
    for x in s["xs"]:
        train_step(ref, crit, torch.from_numpy(x))
    adam = adam_of(s2.opt_state)
    mu, nu, _ = port_moments(state.optimizer, s["aspp"])
    mu32, nu32, _ = port_moments(ref.optimizer, s["aspp"])
    want_mu, want_nu = np_tree(adam.mu), np_tree(adam.nu)
    noise_close(mu, want_mu, mu32, "mu")
    noise_close(nu, want_nu, nu32, "nu")
    eff_got, eff_want = (jtu.tree_map(lambda m: m / 0.1, t) for t in (mu, want_mu))
    got = state_dict_to_variables(state.model.state_dict(), s["aspp"])["params"]
    params_close(got, np_tree(s2.params), eff_got, eff_want, "params")


def test_xla_cpu_sums_a_bf16_cotangent_in_bf16():
    """The divergence the module docstring names: XLA's CPU reduce of bf16
    values accumulates in bf16 (what a bias's gradient is, under autodiff);
    ``f32_sums`` gives the f32 sum rounded once, which ``jnp.sum`` and
    PyTorch (the port) compute."""
    v = np.full((2, 32, 32, 3), 1.0 / 6144.0, np.float32)
    in_bf16 = jax.jit(lambda a: jax_lax.reduce_sum(a, (0, 1, 2)))(jnp.asarray(v).astype(jnp.bfloat16))
    assert np.asarray(in_bf16.astype(jnp.float32))[0] == 0.0625
    with f32_sums():
        widened = jax.jit(lambda a: jax_lax.reduce_sum(a, (0, 1, 2)))(jnp.asarray(v).astype(jnp.bfloat16))
    port = torch.from_numpy(v).to(BF16).sum(dim=(0, 1, 2))
    want = np.float32(torch.tensor(v.sum((0, 1, 2))[0]).to(BF16).float())
    assert np.asarray(widened.astype(jnp.float32))[0] == float(port[0].float()) == want
    assert abs(want - 1.0 / 3.0) < 2.0**-9


def test_train_mode_batchnorm_bf16_matches_flax():
    """The port's BatchNorm in train mode on a bf16 input against Flax's
    (``dtype=bf16``, momentum 0.9, epsilon 1e-5): the f32 batch statistics
    of the widened input, the output rounded to bf16 once, the f32 running
    statistics, and the gradients of the input (bf16) and of the f32 scale
    and bias through the rounding."""
    rng = np.random.default_rng(23)
    c = 16
    x = torch.from_numpy((rng.standard_normal((4, 6, 6, c)) * 0.7 + 0.3).astype(np.float32)).to(BF16)
    ct = rng.standard_normal((4, 6, 6, c)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), (rng.standard_normal(c) * 0.1).astype(np.float32)
    mean0, var0 = (rng.standard_normal(c) * 0.1).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    def loss(params, xx):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * ct), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (g_params, g_x) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(variables["params"], xj)
    assert want_y.dtype == jnp.bfloat16 and g_x.dtype == jnp.bfloat16

    port = BatchNorm(c, BF16).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    y = port(xt)
    assert y.dtype == BF16 and port.running_mean.dtype == port.running_var.dtype == torch.float32
    (y.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    assert xt.grad.dtype == BF16 and port.weight.grad.dtype == torch.float32

    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).float().detach().numpy(), f(want_y), rtol=2.0**-7, atol=2.0**-10)
    np.testing.assert_allclose(port.running_mean.numpy(), f(want_stats["mean"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), f(want_stats["var"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).float().numpy(), f(g_x), rtol=2.0**-7, atol=2.0**-10)
    np.testing.assert_allclose(port.weight.grad.numpy(), f(g_params["scale"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.bias.grad.numpy(), f(g_params["bias"]), rtol=1e-4, atol=1e-6)


def test_cli_trains_in_bf16_with_remat_and_predicts_from_it(tmp_path):
    """``--mode train --use_amp --remat`` through the CLI on a few tiny
    photos: the checkpoint keeps its format (f32 parameters and Adam
    moments, the plain net's names), an f32 net loads it, and ``--mode
    predict --use_amp`` writes its three PNGs from it."""
    from PIL import Image

    from retinex_tpu_torch import cli

    src = tmp_path / "photos"
    src.mkdir()
    rng = np.random.default_rng(29)
    for i in range(4):
        Image.fromarray((rng.random((40, 48, 3)) * 90).astype(np.uint8)).save(src / f"img_{i}.png")
    save = tmp_path / "run"
    cli.main(["--mode", "train", "--use_amp", "--remat", "--train_dir", str(src), "--save_dir", str(save),
              "--num_epochs", "2", "--batch_size", "2", "--image_size", "32", "--save_freq", "1",
              "--no-use_perceptual_loss", "--device", "cpu", "--num_workers", "2"])
    ckpt = torch.load(save / "latest", map_location="cpu", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["epoch"] == 1
    sd = ckpt["model_state_dict"]
    assert all(v.dtype == torch.float32 for k, v in sd.items() if v.is_floating_point())
    assert all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point())
    plain = MultiScaleUPRetinex(False, False)
    plain.load_state_dict(sd)  # the names of the net without remat
    out = tmp_path / "pred"
    cli.main(["--mode", "predict", "--use_amp", "--checkpoint", str(save / "best"), "--input_path",
              str(src / "img_0.png"), "--output_dir", str(out), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [f"img_0_{k}.png" for k in ("comparison", "enhanced",
                                                                                 "illumination")]
