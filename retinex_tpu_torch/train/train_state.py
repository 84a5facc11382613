"""The optimizer, the train state and the train step, in PyTorch.

Counterpart of ``retinex_tpu/train/train_state.py``. The optimizer is the
JAX package's optax chain, written out:

1. clip by global norm ``max_grad_norm`` by optax's rule: the gradient stays
   as it is if its norm is under the bound, else it becomes
   ``g / norm * max_grad_norm`` (``torch.nn.utils.clip_grad_norm_`` would
   divide by ``norm + 1e-6``);
2. add ``weight_decay * p`` to every parameter's gradient (BatchNorm's scale
   and bias included);
3. Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, optax's bias correction);
4. scale by minus the schedule's learning rate at the count of applied
   updates.

``grad_accum > 1`` is ``optax.MultiSteps``: the running mean of k
micro-batch gradients, ``acc + (g - acc) / (n + 1)``, goes through the chain
as one gradient on every k-th call; the other calls leave the parameters as
they are. BatchNorm statistics and the DWA carry update on every
micro-batch, and the learning rate counts applied updates.

Every operation stays on the device; nothing here waits for the card.
Across ranks (``parallel/distributed.py``) every rank takes the step on its
rows of the global batch with the global batch's statistics and summed
gradients, so the clipped Adam update runs on the same gradients on every
rank and the parameters stay the same without a broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from retinex_tpu_torch.losses.total import LossState, TotalLoss
from retinex_tpu_torch.models.layers import Dropout
from retinex_tpu_torch.models.packed_train import packed_train_apply
from retinex_tpu_torch.parallel.distributed import sum_gradients


class Optimizer:
    """The chain above over a model's named parameters (in place)."""

    def __init__(
        self,
        named_params: dict[str, torch.Tensor],
        lr_schedule: Callable[[int], float],
        weight_decay: float = 1e-5,
        max_grad_norm: float = 1.0,
        grad_accum: int = 1,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params = dict(named_params)
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum = max(grad_accum, 1)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0  # applied updates: Adam's count and the schedule's
        self.acc = {k: torch.zeros_like(p) for k, p in self.params.items()} if self.grad_accum > 1 else {}
        self.mini_step = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> bool:
        """Take one micro-batch's gradients; returns whether the parameters
        were updated."""
        if self.grad_accum == 1:
            self._apply(grads)
            return True
        n = self.mini_step
        for k, g in grads.items():
            self.acc[k].add_((g - self.acc[k]) / (n + 1))
        if n < self.grad_accum - 1:
            self.mini_step += 1
            return False
        self._apply(self.acc)
        for a in self.acc.values():
            a.zero_()
        self.mini_step = 0
        return True

    def _apply(self, grads: dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads.values()]).sum())
        keep = norm < self.max_grad_norm
        lr = np.float32(self.lr_schedule(self.count))
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        for k, p in self.params.items():
            g = torch.where(keep, grads[k], grads[k] / norm * self.max_grad_norm)
            g = g + self.weight_decay * p
            self.mu[k].copy_((1 - self.b1) * g + self.b1 * self.mu[k])
            self.nu[k].copy_((1 - self.b2) * (g * g) + self.b2 * self.nu[k])
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.add_(float(-lr) * update)

    def state_dict(self) -> dict:
        return {
            "mu": {k: v.clone() for k, v in self.mu.items()},
            "nu": {k: v.clone() for k, v in self.nu.items()},
            "count": self.count,
            "acc": {k: v.clone() for k, v in self.acc.items()},
            "mini_step": self.mini_step,
            "grad_accum": self.grad_accum,
        }

    def load_state_dict(self, state: dict) -> None:
        if int(state["grad_accum"]) != self.grad_accum:
            raise ValueError(
                f"the checkpoint was written with grad_accum {state['grad_accum']}; resume with the same value"
            )
        with torch.no_grad():
            for key in ("mu", "nu", "acc"):
                for k, v in state[key].items():
                    getattr(self, key)[k].copy_(v)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


@dataclasses.dataclass
class TrainState:
    """Everything a step changes and a checkpoint keeps: the model (its
    parameters and BatchNorm statistics), the optimizer, the DWA carry, the
    dropout generator and the count of train-step calls."""

    model: torch.nn.Module
    optimizer: Optimizer
    loss_state: LossState
    dropout_gen: torch.Generator
    step: int = 0


def create_train_state(
    model: torch.nn.Module,
    lr_schedule: Callable[[int], float],
    seed: int = 0,
    weight_decay: float = 1e-5,
    max_grad_norm: float = 1.0,
    grad_accum: int = 1,
) -> TrainState:
    """A train state over `model` (on its device, in train mode), its
    dropout generator on that device seeded with `seed`."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    opt = Optimizer(dict(model.named_parameters()), lr_schedule, weight_decay, max_grad_norm, grad_accum)
    return TrainState(model=model.train(), optimizer=opt, loss_state=LossState.create(device), dropout_gen=gen)


def loss_and_grads(state: TrainState, criterion: TotalLoss, batch: torch.Tensor, packed: bool = False):
    """The train-mode forward (updating the BatchNorm statistics), the
    losses and their gradients: (grads by name, loss_dict, new LossState).
    `packed` evaluates the forward with the full- and half-resolution
    stages s2d-packed (``models/packed_train.py``; H and W multiples of
    32): the same parameters, statistics and losses up to float
    reassociation, as the JAX package's ``make_train_step(packed=True)``.
    Across ranks `batch` is this rank's rows of the global batch, and the
    gradients are summed over the ranks: the global batch's gradients
    (``parallel/distributed.py``)."""
    model = state.model.train()
    enhanced, reflectance, illu = packed_train_apply(model, batch) if packed else model(batch)
    total, loss_dict, new_loss_state = criterion(batch, enhanced, illu, reflectance, state.loss_state)
    names = list(state.optimizer.params)
    grads = sum_gradients(list(torch.autograd.grad(total, [state.optimizer.params[k] for k in names])))
    return dict(zip(names, grads)), {k: v.detach() for k, v in loss_dict.items()}, new_loss_state


def train_step(
    state: TrainState, criterion: TotalLoss, batch: torch.Tensor, packed: bool = False
) -> dict[str, torch.Tensor]:
    """One step on an NHWC float [0,1] batch, in place (the packed forward
    with `packed`); returns the loss dict (device scalars)."""
    grads, loss_dict, new_loss_state = loss_and_grads(state, criterion, batch, packed)
    state.optimizer.step(grads)
    state.loss_state = new_loss_state
    state.step += 1
    return loss_dict


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: torch.Tensor):
    """The inference forward: batch -> (enhanced, reflectance, illumination)."""
    was_training = model.training
    out = model.eval()(batch)
    model.train(was_training)
    return out
