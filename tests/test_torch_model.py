"""The port's MultiScaleUPRetinex against the JAX package's, same weights.

Weights come from the JAX ``model.init`` with numpy-randomised BatchNorm
statistics, carried across by ``variables_to_state_dict``. Tolerances follow
tests/test_packed_inference.py: illumination atol 2e-5; reflectance and
enhanced atol 2e-3, because X / (I + eps) amplifies float reassociation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu.models.layers import max_pool_nonneg as jax_max_pool
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.layers import max_pool_nonneg
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _jax_variables(use_preact, use_aspp, x, rng):
    model = JaxNet(use_preact=use_preact, use_aspp=use_aspp)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    leaves, treedef = jax.tree_util.tree_flatten(variables["batch_stats"])
    stats = [rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32) for leaf in leaves]
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_unflatten(treedef, stats)}
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("use_preact,use_aspp", FLAGS)
def test_forward_matches_jax(rng, use_preact, use_aspp):
    x = rng.random((1, 64, 64, 3), dtype=np.float32) * 0.6 + 0.05
    model, variables = _jax_variables(use_preact, use_aspp, x, rng)
    want = [np.asarray(a) for a in model.apply(variables, jnp.asarray(x), train=False)]

    port = MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp).eval()
    port.load_state_dict(variables_to_state_dict(variables, use_preact, use_aspp))
    with torch.inference_mode():
        enh, refl, illu = (a.numpy() for a in port(torch.from_numpy(x)))
    assert enh.shape == want[0].shape and illu.shape == want[2].shape
    np.testing.assert_allclose(illu, want[2], atol=2e-5)
    np.testing.assert_allclose(refl, want[1], atol=2e-3)
    np.testing.assert_allclose(enh, want[0], atol=2e-3)


@pytest.mark.parametrize("use_preact,use_aspp", FLAGS)
def test_state_dict_round_trips_to_jax_variables(use_preact, use_aspp):
    """port.state_dict() -> the JAX package's converter gives back exactly
    the variables the port was loaded from."""
    rng = np.random.default_rng(1)
    _, variables = _jax_variables(use_preact, use_aspp, np.zeros((1, 32, 32, 3), np.float32), rng)
    port = MultiScaleUPRetinex(use_preact=use_preact, use_aspp=use_aspp)
    port.load_state_dict(variables_to_state_dict(variables, use_preact, use_aspp))
    back = torch_state_dict_to_variables(port.state_dict(), use_preact, use_aspp)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window,stride,pad", [(3, 1, 1), (2, 2, 0), (4, 4, 0)])
def test_max_pool_nonneg_matches_jax(rng, window, stride, pad):
    x = rng.random((2, 18, 22, 5), dtype=np.float32)
    want = np.asarray(jax_max_pool(jnp.asarray(x), (window, window), (stride, stride), [(pad, pad), (pad, pad)]))
    got = max_pool_nonneg(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride, pad).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_untrained_init_is_seeded():
    a = init_untrained(MultiScaleUPRetinex(False, False), seed=3).state_dict()
    b = init_untrained(MultiScaleUPRetinex(False, False), seed=3).state_dict()
    c = init_untrained(MultiScaleUPRetinex(False, False), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fusion.weight"], c["fusion.weight"])
