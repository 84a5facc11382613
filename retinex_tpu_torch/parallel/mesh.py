"""The data mesh of batch-parallel inference.

Counterpart of ``retinex_tpu/parallel/mesh.py``. There a mesh is a 1-D
``jax.sharding.Mesh`` with one ``data`` axis, a batch is split along it and
the parameters are replicated. Here a ``Mesh`` is the ordered tuple of the
``torch.device``s this process drives: ``shard_batch`` splits a batch along
dim 0, one slice per device, and ``replicate`` keeps one copy of a model's
weights on each device. Training across devices runs one process per device
instead (``parallel/distributed.py``), as NCCL takes one rank per GPU.

``create_mesh`` raises where more devices are asked for than are visible
(the JAX function quietly takes what there is). With ``device="cpu"`` it
returns ``n`` logical CPU shards, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``; a ``Mesh`` may also repeat one
device, which runs the sharded path on a machine with one card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from retinex_tpu_torch.device import resolve_device

DATA_AXIS = "data"  # the JAX mesh's one axis: the batch is split along it


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a data mesh, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def create_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """A mesh over cards 0 to n-1 (``None``: every visible card); with
    `device` "cpu", `n_devices` logical shards of the CPU (``None``: one).
    Raises if `n_devices` is below 1 or above the visible cards."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"--n_devices {n_devices}: a mesh needs at least one device")
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1))
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n > visible:
        raise ValueError(f"--n_devices {n}: {n} CUDA devices asked for, {visible} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple (repeating the last sample);
    returns (padded, original_count) so metrics can mask the padding."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n


def shard_batch(batch, mesh: Mesh) -> list[torch.Tensor]:
    """Split a host batch (numpy or a CPU tensor) along dim 0, one equal
    slice per mesh device, each copied to its device. The batch size must
    be a multiple of the mesh size (``pad_to_multiple``)."""
    x = torch.as_tensor(batch)
    if x.shape[0] % mesh.size:
        raise ValueError(f"batch of {x.shape[0]} does not split over a mesh of {mesh.size}")
    return [part.to(d, non_blocking=True) for part, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


def replicate(make: Callable[[torch.device], Callable], mesh: Mesh) -> Callable:
    """One ``make(device)`` per distinct mesh device (each holding its own
    copy of the weights), behind one callable that runs the copy on its
    first argument's device."""
    copies = {d: make(d) for d in dict.fromkeys(mesh.devices)}

    def on_device(x: torch.Tensor, *args, **kwargs):
        return copies[x.device](x, *args, **kwargs)

    return on_device
