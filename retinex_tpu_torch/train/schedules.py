"""Learning-rate schedules as functions of the epoch, in float32.

Counterpart of ``retinex_tpu/train/schedules.py``, whose schedules run in
f32 inside the jitted train step. Each function here evaluates the program
XLA compiles for them, operation by operation in f32: a division by a
constant is a product by its f32 reciprocal, products of constants are
folded into one f32 constant, the last multiply-add is one fma, and the
elementary functions
(``power``, ``log``, ``cos``) are rounded once from float64. The trainer
maps an applied optimizer step to its epoch as
``(step * grad_accum) // steps_per_epoch`` (``train/trainer.py``).
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def _f(fn, *args) -> np.float32:
    """An elementary function of f32 arguments, rounded once to f32."""
    return F32(fn(*(float(a) for a in args)))


def step_decay(base_lr: float, step_size: int = 30, gamma: float = 0.5):
    """torch StepLR's rule: lr = base * gamma^(epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return float(_f(math.pow, F32(gamma), F32(epoch // step_size)) * F32(base_lr))

    return schedule


def cosine_warm_restarts(base_lr: float, t_0: int = 10, t_mult: int = 2, eta_min: float = 1e-6):
    """torch CosineAnnealingWarmRestarts' rule, in the JAX package's closed
    form: restart periods T_0, T_0 * t_mult, ... and
    lr = eta_min + (base - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2."""

    def schedule(epoch: int) -> float:
        e = F32(epoch)
        if t_mult == 1:
            t_cur = F32(math.fmod(e, F32(t_0)))
            arg = t_cur * (F32(math.pi) * F32(1.0 / t_0))
        else:
            x = e * (F32(1.0 / t_0) * F32(t_mult - 1)) + F32(1.0)
            n = np.floor(_f(math.log, x) * F32(1.0 / _f(math.log, F32(t_mult))))
            p = _f(math.pow, F32(t_mult), n)
            t_cur = e - (p - F32(1.0)) * (F32(t_0) * F32(1.0 / (t_mult - 1)))
            arg = t_cur * F32(math.pi) / (p * F32(t_0))
        c = _f(math.cos, arg)
        # XLA fuses the last multiply and add into one fma.
        return float(F32(float(F32(1.0) + c) * float(F32((base_lr - eta_min) / 2.0)) + float(F32(eta_min))))

    return schedule
