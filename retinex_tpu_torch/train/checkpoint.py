"""Full-state checkpoints of the port's training, as torch files.

Counterpart of ``retinex_tpu/train/checkpoint.py`` (Orbax directories there,
which the port cannot read: orbax imports jax). ``<save_dir>/latest`` and
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
"""

from __future__ import annotations

import os

import torch

from retinex_tpu_torch.losses.total import LossState


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
    """Restore a checkpoint into `state` (in place, onto its device).
    Returns (state, start_epoch, best_loss, extra); start_epoch is the
    saved epoch + 1."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    device = next(state.model.parameters()).device
    state.model.load_state_dict(ckpt["model_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    ls = ckpt["loss_state"]
    state.loss_state = LossState(prev=ls["prev"].to(device), prev2=ls["prev2"].to(device), step=ls["step"].to(device))
    state.dropout_gen.set_state(ckpt["dropout_rng"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]) + 1, float(ckpt["best_loss"]), ckpt.get("extra", {})
