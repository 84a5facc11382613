"""Faults planted under a run's timed path, for the tests and for reading
the faults' numbers on the card (``calibrate.py``). Each is a context
manager that patches the program by module attribute and restores it.

- ``altered_answer``: Lab-CLAHE's result altered where it is produced (its
  red channel one level up) on the enhance routes;
- ``half_batch``: half of each batch left out. Enhance: the net runs on the
  first half and the rest of the outputs are zeros. Training: the step runs
  on the first half, its losses the mean over it;
- ``unchanged``: the training step's optimizer leaves the state as it is;
- ``unchanged_in_window``: the same from the window's first step on, after
  set-up's steps updated the state (a step that goes stale once warm).
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    """``owner.attr`` (a module's name or an object) replaced by
    ``make(original)`` while the block runs."""
    obj = importlib.import_module(owner) if isinstance(owner, str) else owner
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def altered_answer():
    def make(orig):
        def clahe_lab_rgb(x, *args, **kwargs):
            out = orig(x, *args, **kwargs).clone()
            out[..., 0] = torch.clamp(out[..., 0] + 1.0 / 255.0, 0.0, 1.0)
            return out

        return clahe_lab_rgb

    return _patched("retinex_tpu_torch.infer.adaptive_params", "clahe_lab_rgb", make)


def half_batch_enhance():
    def make(orig):
        def call(self, x):
            half = max(x.shape[0] // 2, 1)
            outs = orig(self, x[:half])
            return tuple(torch.cat([o, torch.zeros_like(o[:1]).expand(x.shape[0] - half, *o.shape[1:])]) for o in outs)

        return call

    mod = importlib.import_module("retinex_tpu_torch.models.packed_inference")
    return _patched(mod.PackedRetinex, "__call__", make)


def half_batch_train():
    def make(orig):
        def train_step(state, criterion, batch, packed=False):
            return orig(state, criterion, batch[: batch.shape[0] // 2], packed)

        return train_step

    return _patched("retinex_tpu_torch.train.train_state", "train_step", make)


def unchanged():
    mod = importlib.import_module("retinex_tpu_torch.train.train_state")
    return _patched(mod.Optimizer, "step", lambda orig: (lambda self, grads: False))


def unchanged_in_window():
    from portbench.drivers.train import REFERENCE_STEPS

    mod = importlib.import_module("retinex_tpu_torch.train.train_state")
    return _patched(mod.Optimizer, "step",
                    lambda orig: (lambda self, grads: self.count < REFERENCE_STEPS and orig(self, grads)))


# Which faults each traffic driver's cells can have.
FAULTS = {
    "directory": {"altered_answer": altered_answer, "half_batch": half_batch_enhance},
    "photo": {"altered_answer": altered_answer},
    "train": {"half_batch": half_batch_train, "unchanged": unchanged},
}
# Faults of the window alone, which set-up's steps do not show.
WINDOW_ONLY = {"train": {"unchanged_in_window": unchanged_in_window}}
