"""tests/test_torch_orbax_write.py's checks on the pre-activation + ASPP net
with ``grad_accum`` 2: three of the port's micro-steps (one update applied,
the third micro-batch's gradient pending in the accumulator, mini-step 1),
then ``save_checkpoint``. The JAX package restores optax ``MultiSteps``'
state from it, and its next micro-step applies the update.

The ASPP's dropout draws another mask in each package, so the JAX
package's own mask for its next step is read from its train-mode forward
(``capture_intermediates``, the key its step folds in from the restored
``dropout_rng``) and given to the port's dropout, as
tests/test_torch_train_step_aspp.py does; the port to port step draws the
port's own mask from the restored generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_orbax_write import (
    RUNS,
    check_jax_restores_bit_for_bit,
    check_metadata_matches_jax,
    check_next_step_matches_jax,
    check_port_round_trip,
    fresh_state,
    port_run,
)
from test_torch_train_step import port_model
from test_torch_train_step_aspp import with_mask

NAME = "preact_aspp"


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return port_run(NAME, tmp_path_factory.mktemp("orbax_write_aspp"))


def jax_mask(run) -> torch.Tensor:
    """The keep mask of the JAX package's next step (where the ASPP's
    fusion output is 0 either choice gives 0)."""
    state = run["jstate"]
    key = jax.random.fold_in(state.dropout_rng, state.step)  # the key its step draws from
    outs, upd = jax.jit(lambda v, x: run["jnet"].apply(v, x, train=True, mutable=["batch_stats", "intermediates"],
                                                       capture_intermediates=True, rngs={"dropout": key}))(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(run["x"]))
    aspp = upd["intermediates"]["ie_net"]["aspp"]
    dropped = np.asarray(aspp["Dropout_0"]["__call__"][0])
    live = np.asarray(aspp["fusion"]["__call__"][0]) != 0
    assert 0.05 < float((dropped[live] == 0).mean()) < 0.15
    return torch.from_numpy(dropped != 0).permute(0, 3, 1, 2)


def test_jax_load_checkpoint_restores_the_port_checkpoint_bit_for_bit(run):
    check_jax_restores_bit_for_bit(run)
    opt = run["jstate"].opt_state
    assert (int(opt.mini_step), int(opt.gradient_step), int(opt.inner_opt_state[2].count)) == (1, 1, 1)
    print(f"the pre-activation + ASPP net's checkpoint, grad_accum 2: {run['bytes']} bytes")


def test_orbax_metadata_matches_a_jax_written_checkpoint(run):
    check_metadata_matches_jax(run)


def test_the_jax_next_step_matches_the_ports(run):
    preact, aspp, _, _ = RUNS[NAME]
    state = fresh_state(NAME, with_mask(port_model(preact, aspp, seed=7), jax_mask(run)))
    back, _, _, _ = load_checkpoint(state, str(run["dir"] / "latest"))
    check_next_step_matches_jax(run, back)


def test_port_to_port_is_exact(run):
    check_port_round_trip(run)
