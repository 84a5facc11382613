"""The port's training checkpoints: the JAX package's Orbax directories,
written and read with numpy and ``train/orbax.py`` (no orbax or jax).

Counterpart of ``retinex_tpu/train/checkpoint.py``. ``save_checkpoint``
writes ``<save_dir>/latest``, and ``<save_dir>/best`` when the loss
improved, as that package's function of the name does: each an Orbax
directory of the tree of its ``_state_to_pytree`` (``state_to_tree``):

- ``params`` and ``batch_stats``: the model's (``convert.state_dict_to_variables``);
- ``opt_state``: ``make_optimizer``'s chain (clip and decay empty, Adam's
  ``count``, ``mu`` and ``nu``, the schedule's ``count``), with
  ``grad_accum > 1`` inside optax ``MultiSteps``' state (``mini_step``,
  ``gradient_step``, ``inner_opt_state``, ``acc_grads``, ``skip_state``);
- ``loss_prev``, ``loss_prev2``, ``loss_step``: the DWA carry;
- ``dropout_rng``: the dropout generator's seed as JAX key data, two
  uint32 words, low word first;
- ``step`` (int32, as a JAX step leaves it), ``epoch`` (int64) and
  ``best_loss`` (float64).

So the JAX package's ``load_checkpoint``, ``load_params_for_inference``,
``--resume``, ``--checkpoint`` and ``scripts/export_serving.py`` take what
the port trained. The JAX tree has no place for the port's own resume
state, so each directory also holds ``SIDE_FILE``, a small torch file: the
dropout generator's whole state and ``extra`` (the trainer's loader
shuffle state and augmentation generator), with the device type they
belong to. Each directory is written beside its place and swapped in
(``_swap_in``): a crash at any point leaves the previous checkpoint or the
new one readable.

``load_checkpoint`` restores such a directory exactly, side file included
(where the device type matches, else as a JAX-written one), the JAX
package's own directories, and the torch files the port wrote before it
wrote directories. From a JAX-written directory it restores the
parameters and BatchNorm statistics, Adam's ``mu``, ``nu`` and ``count``,
with ``grad_accum > 1`` MultiSteps' accumulator and mini-step, the DWA
carry and the step. Where the two packages cannot be the same:

- a ``grad_accum`` that does not match the tree raises (MultiSteps' state
  in a tree resumed with ``grad_accum`` 1, or none with more, or a
  mini-step the run's ``grad_accum`` cannot reach), as the JAX restore
  into its template does;
- the dropout generator is seeded with the JAX key's data (its words, little
  end first, as one 64-bit number): deterministic, though the port's draws
  already differ from JAX's;
- ``extra`` is empty, so the trainer's loader and augmentation restart
  their draws, as the JAX package's do on a resume.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

from retinex_tpu_torch.losses.total import LossState
from retinex_tpu_torch.models.convert import (
    adam_state_to_optax,
    adam_state_to_port,
    param_table,
    state_dict_to_variables,
    variables_to_state_dict,
)
from retinex_tpu_torch.train.orbax import read_orbax, write_orbax

# The port's resume state that the JAX tree has no place for.
SIDE_FILE = "torch_resume.pt"
# Leaves the JAX package holds as numpy arrays (the rest are jax.Arrays).
NUMPY_KEYS = (("epoch",), ("best_loss",))


def state_to_tree(state, epoch: int, best_loss: float) -> dict:
    """The JAX package's ``_state_to_pytree`` of the port's train state, as
    numpy (module docstring); on the CPU its arrays may share the state's
    memory, so a later step changes them."""
    model, opt = state.model, state.optimizer
    variables = state_dict_to_variables(model.state_dict(), model.use_aspp)
    mu, nu, count = adam_state_to_optax({"mu": opt.mu, "nu": opt.nu, "count": opt.count}, model.use_aspp)
    chain = [None, None, {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu},
             {"count": np.asarray(count, np.int32)}]
    opt_state = chain
    if opt.grad_accum > 1:
        opt_state = {
            "mini_step": np.asarray(opt.mini_step, np.int32), "gradient_step": np.asarray(count, np.int32),
            "inner_opt_state": chain, "acc_grads": state_dict_to_variables(opt.acc, model.use_aspp)["params"],
            "skip_state": (),
        }
    seed = state.dropout_gen.initial_seed()
    ls = state.loss_state
    return {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": opt_state,
        "loss_prev": ls.prev.detach().cpu().numpy(),
        "loss_prev2": ls.prev2.detach().cpu().numpy(),
        "loss_step": ls.step.detach().cpu().numpy().astype(np.int32),
        "dropout_rng": np.array([seed & 0xFFFFFFFF, seed >> 32], np.uint32),
        "step": np.asarray(state.step, np.int32),
        "epoch": np.asarray(epoch, np.int64),
        "best_loss": np.asarray(best_loss, np.float64),
    }


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.unlink(path)


def _exchange(a: str, b: str) -> bool:
    """Swap two paths in one step (Linux ``renameat2(RENAME_EXCHANGE)``);
    False where the system or the file system has no such call."""
    fn = getattr(ctypes.CDLL(None, use_errno=True), "renameat2", None)
    if fn is None:
        return False
    at_fdcwd, rename_exchange = -100, 2
    return fn(at_fdcwd, os.fsencode(a), at_fdcwd, os.fsencode(b), rename_exchange) == 0


def _swap_in(new: str, path: str) -> None:
    """Put the finished directory `new` at `path`, whatever was there (an
    older directory or torch file) removed after. With the exchange,
    `path` always holds a whole checkpoint; without it, a crash between the
    two renames leaves the previous one at ``<path>.old`` and the new one at
    `new`."""
    if not os.path.lexists(path):
        os.rename(new, path)
    elif _exchange(new, path):
        _remove(new)
    else:
        old = f"{path}.old"
        _remove(old)
        os.rename(path, old)
        os.rename(new, path)
        _remove(old)


def _write_dir(path: str, tree: dict, side: dict) -> int:
    """`tree` as an Orbax directory at `path` with `side` in ``SIDE_FILE``,
    written at ``<path>.tmp`` and swapped in; returns the bytes written."""
    tmp = f"{path}.tmp"
    _remove(tmp)
    try:
        n = write_orbax(tmp, tree, numpy_keys=NUMPY_KEYS)
        torch.save(side, os.path.join(tmp, SIDE_FILE))
    except BaseException:
        _remove(tmp)
        raise
    _swap_in(tmp, path)
    return n + os.path.getsize(os.path.join(path, SIDE_FILE))


def save_checkpoint(
    state, save_dir: str, epoch: int, best_loss: float, is_best: bool, extra: dict | None = None
) -> int:
    """Write ``latest`` always, and ``best`` when `is_best` (module
    docstring); returns the bytes of one directory."""
    os.makedirs(save_dir, exist_ok=True)
    tree = state_to_tree(state, epoch, best_loss)
    gen = state.dropout_gen
    side = {"device": gen.device.type, "dropout_rng": gen.get_state(), "extra": extra or {}}
    n = _write_dir(os.path.join(save_dir, "latest"), tree, side)
    if is_best:
        _write_dir(os.path.join(save_dir, "best"), tree, side)
    return n


def load_checkpoint(state, path: str):
    """Restore a checkpoint into `state` (in place, onto its device): an
    Orbax directory (the port's or the JAX package's) or one of the torch
    files the port wrote before. Returns (state, start_epoch, best_loss,
    extra); start_epoch is the saved epoch + 1."""
    if os.path.isdir(path):
        return _load_orbax(state, path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    device = next(state.model.parameters()).device
    state.model.load_state_dict(ckpt["model_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    ls = ckpt["loss_state"]
    state.loss_state = LossState(prev=ls["prev"].to(device), prev2=ls["prev2"].to(device), step=ls["step"].to(device))
    state.dropout_gen.set_state(ckpt["dropout_rng"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]) + 1, float(ckpt["best_loss"]), ckpt.get("extra", {})


def load_params_for_inference(path: str) -> dict:
    """``{'params', 'batch_stats'}`` of an Orbax checkpoint as numpy trees,
    as the JAX package's function of this name returns them, whatever mesh
    wrote them."""
    tree = read_orbax(path, select=("params", "batch_stats"))
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def _flat(tree, path=()) -> set:
    if isinstance(tree, dict):
        return set().union(*(_flat(v, (*path, k)) for k, v in tree.items())) if tree else set()
    return {path}


def state_dict_for(model, variables) -> dict[str, torch.Tensor]:
    """The Flax variables as `model`'s state_dict; ValueError naming the
    missing and the extra leaves, or the leaves whose shapes differ, where
    they were written for another net (``use_preact``, ``use_aspp``)."""
    want = model.state_dict()
    expected = {path for name, path, _ in param_table(model.use_aspp) if name in want}
    have = _flat({"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    missing, extra = sorted(expected - have), sorted(have - expected)
    net = f"use_preact={model.use_preact}, use_aspp={model.use_aspp}"
    if missing or extra:
        raise ValueError(
            f"the checkpoint was written for another net than this one ({net}): "
            f"missing {len(missing)} leaves {['/'.join(p) for p in missing[:6]]}, "
            f"extra {len(extra)} leaves {['/'.join(p) for p in extra[:6]]}"
        )
    sd = variables_to_state_dict(variables, model.use_preact, model.use_aspp)
    bad = [f"{k}: checkpoint {tuple(v.shape)}, net {tuple(want[k].shape)}" for k, v in sd.items()
           if v.shape != want[k].shape]
    if bad:
        raise ValueError(f"the checkpoint was written for another net than this one ({net}): shapes {bad[:6]}")
    return sd


def _optimizer_state(opt_state, optimizer, use_aspp: bool) -> dict:
    """``make_optimizer``'s optax state -> ``Optimizer.load_state_dict``'s."""
    multi = isinstance(opt_state, dict) and "inner_opt_state" in opt_state
    k = optimizer.grad_accum
    if multi != (k > 1):
        raise ValueError(
            f"the checkpoint's optimizer was written {'with' if multi else 'without'} gradient accumulation "
            f"(optax.MultiSteps) and this run has grad_accum {k}: resume with "
            f"{'grad_accum > 1' if multi else 'grad_accum 1'}, as the JAX package's restore requires"
        )
    chain = opt_state["inner_opt_state"] if multi else opt_state
    adam = chain[2] if isinstance(chain, list) and len(chain) == 4 else None
    if not isinstance(adam, dict) or not {"count", "mu", "nu"} <= set(adam):
        raise ValueError("opt_state is not make_optimizer's chain (clip, weight decay, Adam, learning rate)")
    moments = adam_state_to_port(adam["mu"], adam["nu"], adam["count"], use_aspp)
    schedule_count = chain[3].get("count") if isinstance(chain[3], dict) else None
    if schedule_count is not None and int(schedule_count) != moments["count"]:
        raise ValueError(f"Adam's count {moments['count']} and the schedule's {int(schedule_count)} differ")
    acc, mini_step = {}, 0
    if multi:
        mini_step = int(opt_state["mini_step"])
        if mini_step >= k:
            raise ValueError(f"the checkpoint is at micro-step {mini_step} of its accumulation; grad_accum {k} is too small")
        acc = adam_state_to_port(opt_state["acc_grads"], opt_state["acc_grads"], 0, use_aspp)["mu"]
    return {**moments, "acc": acc, "mini_step": mini_step, "grad_accum": k}


def _load_orbax(state, path: str):
    tree = read_orbax(path)
    model = state.model
    device = next(model.parameters()).device
    model.load_state_dict(state_dict_for(model, tree))
    state.optimizer.load_state_dict(_optimizer_state(tree["opt_state"], state.optimizer, model.use_aspp))
    state.loss_state = LossState(
        prev=torch.as_tensor(tree["loss_prev"], dtype=torch.float32, device=device),
        prev2=torch.as_tensor(tree["loss_prev2"], dtype=torch.float32, device=device),
        step=torch.as_tensor(tree["loss_step"], dtype=torch.int32, device=device),
    )
    key = np.ascontiguousarray(tree["dropout_rng"], dtype=np.uint32).tobytes()
    state.dropout_gen.manual_seed(int.from_bytes(key, "little") % (1 << 64))
    state.step = int(tree["step"])
    extra = {}
    side_path = os.path.join(path, SIDE_FILE)
    if os.path.exists(side_path):
        side = torch.load(side_path, map_location="cpu", weights_only=True)
        if side["device"] == state.dropout_gen.device.type:
            state.dropout_gen.set_state(side["dropout_rng"])
            extra = side["extra"]
    return state, int(tree["epoch"]) + 1, float(tree["best_loss"]), extra
