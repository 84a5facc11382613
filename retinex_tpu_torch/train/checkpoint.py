"""Full-state checkpoints of the port's training, as torch files, and the
JAX package's Orbax checkpoints read into the port.

Counterpart of ``retinex_tpu/train/checkpoint.py``. The port writes torch
files; it reads those and the JAX package's Orbax directories
(``train/orbax.py``, no orbax or jax): ``load_params_for_inference`` as the
JAX function of that name, and ``load_checkpoint`` restores either kind
into a train state. ``<save_dir>/latest`` and
``<save_dir>/best`` are single files written atomically (to a temporary
file beside them, then renamed). Each holds the whole train state, so a
resume is exact:

- ``model_state_dict``: the parameters and BatchNorm statistics, and
  ``epoch``: the two keys of a reference ``.pth``, so ``--mode predict`` and
  ``--mode enhance`` load these files with ``--checkpoint`` as they load one;
- ``optimizer``: Adam's moments and count, and the ``grad_accum``
  accumulator with its micro-step;
- ``loss_state``: the DWA carry;
- ``dropout_rng``: the dropout generator's state;
- ``step`` (train-step calls) and ``best_loss``;
- ``extra``: what the caller adds (the trainer: its loader's shuffle state
  and its augmentation generator's state).

From an Orbax directory (the JAX package's ``_state_to_pytree``: params,
batch_stats, opt_state, loss_prev, loss_prev2, loss_step, dropout_rng,
step, epoch, best_loss) ``load_checkpoint`` restores the parameters and
BatchNorm statistics, Adam's ``mu``, ``nu`` and ``count`` (the third state
of ``make_optimizer``'s chain: clip, decay, Adam, learning rate), with
``grad_accum > 1`` optax ``MultiSteps``' accumulator and mini-step, the DWA
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

import os

import numpy as np
import torch

from retinex_tpu_torch.losses.total import LossState
from retinex_tpu_torch.models.convert import adam_state_to_port, param_table, variables_to_state_dict
from retinex_tpu_torch.train.orbax import read_orbax


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def state_to_dict(state, epoch: int, best_loss: float, extra: dict | None = None) -> dict:
    return _to_cpu({
        "epoch": int(epoch),
        "model_state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "loss_state": {"prev": state.loss_state.prev, "prev2": state.loss_state.prev2, "step": state.loss_state.step},
        "dropout_rng": state.dropout_gen.get_state(),
        "step": int(state.step),
        "best_loss": float(best_loss),
        "extra": extra or {},
    })


def _atomic_save(obj: dict, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(
    state, save_dir: str, epoch: int, best_loss: float, is_best: bool, extra: dict | None = None
) -> None:
    """Write ``latest`` always, and ``best`` when `is_best`."""
    os.makedirs(save_dir, exist_ok=True)
    obj = state_to_dict(state, epoch, best_loss, extra)
    _atomic_save(obj, os.path.join(save_dir, "latest"))
    if is_best:
        _atomic_save(obj, os.path.join(save_dir, "best"))


def load_checkpoint(state, path: str):
    """Restore a checkpoint into `state` (in place, onto its device): one of
    the port's files or the JAX package's Orbax directory. Returns (state,
    start_epoch, best_loss, extra); start_epoch is the saved epoch + 1."""
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
    return state, int(tree["epoch"]) + 1, float(tree["best_loss"]), {}
