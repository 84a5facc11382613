"""The port's untrained net against the JAX package's ``model.init``.

The JAX CLI initialises an untrained net with
``model.init(jax.random.PRNGKey(0), ...)``: Flax's defaults, lecun_normal
kernels (a normal truncated at +-2 sigma whose samples have std
sqrt(1/fan_in), fan_in = kh * kw * input channels for Conv and
ConvTranspose alike) and zero biases. ``retinex_tpu_torch.cli.init_untrained``
draws the same distribution from torch's generator, so the numbers differ and
the statistics agree. Each layer is matched to its JAX kernel through the
JAX package's converter (``models/convert.py``), which lays the port's
weights out as Flax variables.

Tolerance: the sample std of n draws of a normal truncated at +-2 has a
relative standard error of sqrt((kurtosis - 1) / (4 n)) = 0.584 / sqrt(n)
(kurtosis 2.366); each layer's std, ours and JAX's, is held to sqrt(1/fan_in)
within 5 such errors, and its mean to 0 within 5 standard errors of a mean.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

# The default net and the pre-activation + ASPP net (simple_enhance_main's).
NETS = [(False, False), (True, True)]
STD_SE = 0.584  # relative standard error of a sample std, times sqrt(n)
N_SE = 5.0


@functools.lru_cache(maxsize=None)
def _pairs(use_preact, use_aspp):
    """[(path, port leaf, JAX leaf)] over the params of both inits (cached:
    each net is initialised once per process)."""
    port = cli.init_untrained(MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp), seed=0)
    ours = torch_state_dict_to_variables(port.state_dict(), use_preact, use_aspp)["params"]
    model = JaxNet(use_preact=use_preact, use_aspp=use_aspp)
    theirs = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"]
    a = jax.tree_util.tree_flatten_with_path(ours)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(y)) for (p, x), (_, y) in zip(a, b)]


def _check_lecun(kernel: np.ndarray, what: str) -> None:
    fan_in = math.prod(kernel.shape[:-1])  # Flax: every axis but the output one
    want = math.sqrt(1.0 / fan_in)
    n = kernel.size
    std = float(kernel.std())
    assert abs(std / want - 1) <= N_SE * STD_SE / math.sqrt(n), f"{what}: std {std:.5g}, want {want:.5g} (n {n})"
    assert abs(float(kernel.mean())) <= N_SE * want / math.sqrt(n), f"{what}: mean {float(kernel.mean()):.3g}"
    sigma = want / cli.TRUNC_STD
    assert float(np.abs(kernel).max()) <= 2 * sigma * (1 + 1e-6), f"{what}: a value beyond 2 sigma"


@pytest.mark.parametrize("use_preact,use_aspp", NETS)
def test_untrained_init_matches_flax_per_layer(use_preact, use_aspp):
    """Every kernel, the port's and JAX's, has lecun_normal's std and no
    value beyond 2 sigma; every bias is exactly 0 on both sides."""
    n_kernels = 0
    for path, ours, theirs in _pairs(use_preact, use_aspp):
        assert ours.shape == theirs.shape, path
        if path.endswith("['kernel']"):
            _check_lecun(ours, f"port {path}")
            _check_lecun(theirs, f"JAX {path}")
            n_kernels += 1
        elif path.endswith("['bias']") and "bn" not in path.lower():
            assert not ours.any() and not theirs.any(), f"{path}: a nonzero bias"
        else:  # BatchNorm scale 1, bias 0: identity on both sides
            np.testing.assert_array_equal(ours, theirs, err_msg=path)
    assert n_kernels > 20


@pytest.mark.parametrize("use_preact,use_aspp", NETS)
def test_untrained_up_layers_take_flax_fan_in(use_preact, use_aspp):
    """The decoders' ConvTranspose2d layers: fan_in counts the input
    channels (torch's weight.shape[0]), as Flax's ConvTranspose does, so the
    port's std matches JAX's (taking torch's shape[1], the output channels,
    would give sqrt(2) times it on a halving upsample)."""
    net = MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp)
    ups = [m for m in net.modules() if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(ups) == 3
    for m in ups:
        assert cli.fan_in(m) == m.weight.shape[0] * 4
    pairs = [(p, o, t) for p, o, t in _pairs(use_preact, use_aspp) if "['up']['kernel']" in p]
    assert len(pairs) == 3
    for path, ours, theirs in pairs:
        assert ours.shape[2] > ours.shape[3], f"{path}: expected a channel-halving upsample"
        tol = N_SE * STD_SE * math.sqrt(2.0 / ours.size)  # two sample stds, each with its error
        assert abs(float(ours.std()) / float(theirs.std()) - 1) <= tol, path


def test_cli_untrained_net_ignores_seed(tmp_path):
    """The CLI initialises from seed 0 whatever --seed says, as the JAX CLI
    always uses PRNGKey(0)."""
    cfg = Config(seed=7, checkpoint=str(tmp_path / "missing.pth"))
    got = cli.build_model(cfg, torch.device("cpu")).state_dict()
    want = cli.init_untrained(MultiScaleUPRetinex(use_preact=False, use_aspp=False), seed=0).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert cli.UNTRAINED_SEED == 0
