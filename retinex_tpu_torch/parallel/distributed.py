"""Data-parallel training across devices and hosts, on ``torch.distributed``.

Counterpart of ``retinex_tpu/parallel/distributed.py``. The JAX package runs
one process per host, ``jax.distributed.initialize`` joins them, and its
step is the one-device step on the global batch: GSPMD reduces every mean
over the batch axis across the devices. Here every device is a rank of its
own (NCCL takes one rank per GPU): ``--mode train`` on ``L`` local devices
starts ``L`` processes (``launch``), and with ``--coordinator host:port
--num_processes P --process_id i`` process ``i`` starts global ranks
``i*L`` to ``i*L+L-1`` of a world of ``P*L``, joined through
``tcp://host:port``. The backend is NCCL on the card and gloo on the CPU.

The step stays the global-batch step: each rank holds its rows of the
global batch, and

- the batch statistics (train-mode BatchNorm's sums, the exposure target's
  mean, the colour loss's channel means, the smooth weight's mean
  complexity) are sums over every rank (``all_reduce_sum``);
- every per-sample mean of the loss is this rank's sum over the global
  count (``share_mean``), so the ranks' shares add up to the global loss,
  and the parameter gradients are summed over the ranks
  (``sum_gradients``);
- every rank draws the global batch's dropout mask and augmentation from
  the shared seed and keeps its own rows (``data_shard``).

In a world of one rank none of this runs: no collective is issued and every
function computes what the one-device code always did.

Manual recipe (2 hosts of 4 cards each, a world of 8):
    host0$ python -m retinex_tpu_torch.cli --mode train ... \\
               --coordinator host0:1234 --num_processes 2 --process_id 0
    host1$ python -m retinex_tpu_torch.cli --mode train ... \\
               --coordinator host0:1234 --num_processes 2 --process_id 1
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import sys

import torch
import torch.distributed as dist

# Set by initialize_distributed: (process index, process count, local rank,
# local ranks) of this rank's launch.
_TOPOLOGY = {"process": (0, 1), "local": (0, 1)}
# A rank that waits longer than this in a collective raises (a peer on
# another host has died).
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    """A free TCP port on localhost, for a one-host rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_plan(config) -> tuple[int, int, int]:
    """(process index, process count, local ranks) of a training run.
    ``--n_devices`` counts the devices of the whole run, as the JAX mesh
    does; each process takes an equal share of them (default: every visible
    card, or one CPU rank). Raises as the JAX package does where
    ``--coordinator`` lacks ``--num_processes`` or ``--process_id``."""
    from retinex_tpu_torch.parallel.mesh import create_mesh

    if config.coordinator:
        if config.num_processes is None or config.process_id is None:
            raise ValueError("--coordinator requires --num_processes and --process_id")
        if not 0 <= config.process_id < config.num_processes:
            raise ValueError(f"--process_id {config.process_id} is not in [0, {config.num_processes})")
        procs, index = config.num_processes, config.process_id
    else:
        procs, index = 1, 0
    n = config.n_devices
    if n is not None and n % procs:
        raise ValueError(f"--n_devices {n} does not split over {procs} processes")
    local = create_mesh(None if n is None else n // procs, config.device).size
    return index, procs, local


def initialize_distributed(
    config, local_rank: int = 0, local_ranks: int = 1, init_method: str | None = None, backend: str | None = None
) -> bool:
    """Join this rank's process group; returns False (and does nothing)
    where the run is one rank on one host. With ``--coordinator`` the rank
    is ``process_id * local_ranks + local_rank`` of ``num_processes *
    local_ranks``, joined through ``tcp://<coordinator>``; without it the
    local ranks meet at `init_method`. `backend` defaults to NCCL on the
    card and gloo on the CPU."""
    if config.coordinator:
        if config.num_processes is None or config.process_id is None:
            raise ValueError("--coordinator requires --num_processes and --process_id")
        procs, index = config.num_processes, config.process_id
        init_method = f"tcp://{config.coordinator}"
    elif local_ranks > 1 or init_method is not None:
        procs, index = 1, 0
    else:
        return False
    device = torch.device(config.device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    card = None
    if device.type == "cuda":
        card = torch.device("cuda", local_rank if device.index is None else device.index)
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=procs * local_ranks,
        rank=index * local_ranks + local_rank,
        timeout=COLLECTIVE_TIMEOUT,
        device_id=card if backend == "nccl" else None,
    )
    _TOPOLOGY.update(process=(index, procs), local=(local_rank, local_ranks))
    return True


def shutdown() -> None:
    """Leave the process group (after a last barrier), if one was joined."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _TOPOLOGY.update(process=(0, 1), local=(0, 1))


def process_shard() -> tuple[int, int]:
    """(process_index, process_count) — (0, 1) single-host."""
    return _TOPOLOGY["process"]


def local_shard() -> tuple[int, int]:
    """(local rank, local ranks) of this process's launch — (0, 1) alone."""
    return _TOPOLOGY["local"]


def local_batch_size(global_batch_size: int) -> int:
    """Per-process share of the global batch (every process must contribute
    the same local size, so the global batch must divide evenly)."""
    count = process_shard()[1]
    if global_batch_size % count:
        raise ValueError(f"global batch size {global_batch_size} not divisible by {count} processes")
    return global_batch_size // count


def data_shard() -> tuple[int, int]:
    """(rank, world) of the batch axis: this rank's rows are the rank-th of
    `world` equal slices of the global batch. (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_world() -> int:
    return data_shard()[1]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum over the ranks too.
    For a statistic that each rank uses on its own rows (BatchNorm's): rank
    r's outputs depend on every rank's inputs through it."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class _AllReduceThrough(torch.autograd.Function):
    """The sum over the ranks; its gradient passes through unchanged. For a
    statistic of a loss term that every rank computes whole (the colour
    loss): each rank's gradient then carries its own rows' part of the
    term's gradient once, and the sum of the parameter gradients counts the
    term once (an all-reduce here would count it world-size times)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def all_reduce_sum(t: torch.Tensor, through: bool = False) -> torch.Tensor:
    """`t` summed over the ranks (differentiable; see the two classes for
    the backward `through` picks). `t` itself in a world of one."""
    if data_world() == 1:
        return t
    return (_AllReduceThrough if through else _AllReduceSum).apply(t)


def share_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: ``x.mean()``
    in a world of one, else x's sum over the global count (every rank holds
    as many rows), so that the shares add up to the mean."""
    world = data_world()
    if world == 1:
        return x.mean()
    return x.sum() / (x.numel() * world)


def global_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean over the global batch of x (over `dim`, or every axis),
    whole on every rank: ``x.mean(dim)`` in a world of one, else the summed
    sums over the global count, their gradient passed straight through (a
    statistic of a loss term every rank computes whole)."""
    world = data_world()
    dims = tuple(range(x.ndim)) if dim is None else dim
    if world == 1:
        return x.mean() if dim is None else x.mean(dim=dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return all_reduce_sum(x.sum(dim=dims), through=True) / (count * world)


def sum_gradients(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients summed over the ranks (one all-reduce of their
    concatenation); the list itself in a world of one."""
    if data_world() == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at : at + g.numel()].view_as(g))
        at += g.numel()
    return out


def any_over_ranks(flag: bool, device: torch.device) -> bool:
    """Whether any rank's `flag` is set (the preemption agreement: every
    rank takes the break at the same step). `flag` alone in a world of one."""
    if data_world() == 1:
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def check_replicas_equal(tensors, what: str = "parameters") -> None:
    """Raise unless every rank holds the same `tensors`, by two float64
    checksums (the sum, and a sum weighted by position) compared by their
    maximum and minimum over the ranks."""
    if data_world() == 1:
        return
    sums = []
    for t in tensors:
        v = t.detach().double().reshape(-1)
        sums.append(torch.stack([v.sum(), (v * torch.arange(1, v.numel() + 1, device=v.device)).sum()]))
    cs = torch.stack(sums).sum(0)
    if dist.get_backend() == "nccl":  # NCCL reduces tensors on the card only
        cs = cs.to(torch.device("cuda", torch.cuda.current_device()))
    hi, lo = cs.clone(), -cs
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX)
    if not torch.equal(hi, -lo):
        raise RuntimeError(f"the ranks' {what} differ (checksums from {(-lo).tolist()} to {hi.tolist()})")


def barrier() -> None:
    if data_world() > 1:
        dist.barrier()


def rank_device(config) -> torch.device:
    """The device of this rank: the CPU, the card `config.device` names, or
    else the card of the local rank."""
    device = torch.device(config.device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_shard()[0])
    return device


def _rank_entry(local_rank, fn, args, config, local_ranks, init_method, backend, result_path):
    """One spawned rank: join the group, run fn(*args), leave. The first
    local rank saves fn's value to `result_path`; ranks other than the
    first global one print nothing. (An error ends the rank with its traceback, which ``launch``
    raises.)"""
    first_process = not config.coordinator or config.process_id == 0
    if local_rank != 0 or not first_process:
        sys.stdout = open(os.devnull, "w")
    if torch.device(config.device).type == "cpu":  # the host's cores shared among its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // local_ranks))
    initialize_distributed(config, local_rank, local_ranks, init_method, backend)
    value = fn(*args)
    if local_rank == 0:
        torch.save(value, result_path)
    shutdown()


def launch(fn, args: tuple, config, local_ranks: int, backend: str | None = None):
    """Run ``fn(*args)`` in `local_ranks` new processes, one rank each (on
    the card, local rank l drives cuda:l), joined as ``initialize_distributed``
    says; returns the value of this process's first rank. A rank that fails ends the others, and this raises
    with its traceback. SIGTERM sent to this process is passed on to the
    ranks (the trainer's preemption checkpoint); SIGINT from a terminal
    reaches them directly, so this process ignores it."""
    import tempfile

    import torch.multiprocessing as mp

    init_method = None if config.coordinator else f"tcp://127.0.0.1:{free_port()}"
    fd, result_path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    os.unlink(result_path)
    procs = mp.start_processes(
        _rank_entry,
        args=(fn, args, config, local_ranks, init_method, backend, result_path),
        nprocs=local_ranks,
        join=False,
        start_method="spawn",
    )

    def forward(_signum, _frame):
        for p in procs.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    old = {}
    try:
        old[signal.SIGTERM] = signal.signal(signal.SIGTERM, forward)
        old[signal.SIGINT] = signal.signal(signal.SIGINT, signal.SIG_IGN)
    except ValueError:  # not the main thread: no handlers
        old = {}
    try:
        while not procs.join():
            pass
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
    if not os.path.exists(result_path):
        return None
    try:
        return torch.load(result_path, weights_only=False)
    finally:
        os.unlink(result_path)
