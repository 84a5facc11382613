"""One train step on the ranks of a data-parallel run.

``sharded_steps`` starts `world` ranks (``parallel/distributed.launch``); each
builds the same train state (the weights of `state_dict`, or untrained from
``spec.seed``), takes its rows of the global batch and runs one step
(``train/train_state.train_step``) for each spec, and the first rank's
losses, parameters and BatchNorm statistics come back. ``one_step`` is the same step in this
process, on the whole batch, with no process group: the one-device step the
ranks must equal (the JAX package's data-parallel step is its one-device
step on the global batch). ``graft_entry.dryrun_multichip``,
``chip_smoke.py``'s phase 23 and the tests drive these two.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from retinex_tpu_torch.config import Config
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.losses.total import LossConfig, TotalLoss
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.parallel.distributed import barrier, data_shard, launch, rank_device


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """The net, the losses and the step of a check."""

    use_preact: bool = False
    use_aspp: bool = False
    packed: bool = False
    lr: float = 1e-3
    seed: int = 0
    loss: LossConfig = LossConfig(use_perceptual_loss=False)
    timed: int = 0  # steps timed after the checked one (the first of them a warm-up)
    deterministic: bool = False  # cuDNN's deterministic algorithms, so two runs can match bit for bit


def one_step(spec: StepSpec, batch: np.ndarray, device, state_dict: dict | None = None) -> dict:
    """One train step on this rank's rows of `batch` (the whole of it
    without a process group) on `device`: {"loss": {name: float}, "params":
    {name: CPU tensor}, "mu": {name: Adam's first moment, 0.1 of the
    clipped gradient}, "stats": {BatchNorm buffer: CPU tensor}}, and with
    ``spec.timed`` "ms": the median of the further steps' times after the
    first (each from a barrier to its loss on the host)."""
    device = torch.device(device)
    saved = torch.backends.cudnn.deterministic
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = spec.deterministic
    try:
        return _one_step(spec, batch, device, state_dict)
    finally:
        torch.backends.cudnn.deterministic = saved


def _one_step(spec: StepSpec, batch: np.ndarray, device: torch.device, state_dict: dict | None) -> dict:
    from retinex_tpu_torch.models.vgg import default_vgg
    from retinex_tpu_torch.train.train_state import create_train_state, train_step

    model = MultiScaleUPRetinex(use_preact=spec.use_preact, use_aspp=spec.use_aspp)
    if state_dict is None:
        init_untrained(model, spec.seed)
    else:
        model.load_state_dict(state_dict)
    vgg = default_vgg().to(device).eval() if spec.loss.use_perceptual_loss else None
    state = create_train_state(model.to(device), lambda _step: spec.lr, seed=spec.seed)
    rank, world = data_shard()
    rows = batch.shape[0] // world
    x = torch.from_numpy(np.ascontiguousarray(batch[rank * rows : (rank + 1) * rows])).to(device)
    criterion = TotalLoss(spec.loss, vgg=vgg)
    loss = train_step(state, criterion, x, spec.packed)
    sd = state.model.state_dict()
    out = {
        "loss": {k: float(v) for k, v in loss.items()},
        "params": {k: v.detach().cpu().clone() for k, v in state.optimizer.params.items()},
        "mu": {k: v.detach().cpu().clone() for k, v in state.optimizer.mu.items()},
        "stats": {k: v.detach().cpu().clone() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))},
    }
    times = []
    for _ in range(spec.timed):
        barrier()
        t0 = time.perf_counter()
        float(train_step(state, criterion, x, spec.packed)["total"])
        times.append((time.perf_counter() - t0) * 1e3)
    if times:
        out["ms"] = statistics.median(times[1:] or times)
    return out


def _rank_steps(config, specs, batch, state_dicts):
    from retinex_tpu_torch.parallel.distributed import check_replicas_equal

    outs = []
    for spec, state_dict in zip(specs, state_dicts):
        out = one_step(spec, batch, rank_device(config), state_dict)
        # The summed gradients leave every rank with the same parameters.
        check_replicas_equal(list(out["params"].values()) + list(out["stats"].values()), "parameters after the step")
        outs.append(out)
    return outs


def sharded_steps(
    world: int,
    specs: list[StepSpec],
    batch: np.ndarray,
    device: str | None = None,
    backend: str | None = None,
    state_dicts: list | None = None,
) -> list[dict]:
    """``one_step`` for each of `specs`, each from a fresh state (the
    weights of the matching entry of `state_dicts`, or untrained), in
    `world` new processes, one rank each (gloo on the CPU, NCCL on the card
    unless `backend` says otherwise), each on its rows of `batch` (its size
    a multiple of `world`); returns the first rank's results. `device`:
    None or "cuda" puts each rank on the card of its local rank, "cuda:0"
    every rank on that card, "cpu" the CPU (``device.resolve_device``:
    without a card only "cpu" runs)."""
    if batch.shape[0] % world:
        raise ValueError(f"batch of {batch.shape[0]} does not split over {world} ranks")
    config = Config(device=str(resolve_device(device)))
    state_dicts = list(state_dicts or [None] * len(specs))
    return launch(_rank_steps, (config, list(specs), batch, state_dicts), config, world, backend)
