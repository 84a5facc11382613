"""What every traffic driver shares: the cell's knobs, the program's
numerics flags, the comparison's result lines."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import shutil
import sys
import time

import torch


def f32_backend() -> None:
    """The program's f32 as its CLI sets it: no TF32 in cuDNN or cuBLAS, bf16
    products summed in f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclasses.dataclass
class Check:
    """One compared number beside its limit; the run is correct where every
    value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Window:
    """What a timed window did: requests (or steps) attempted and failed, the
    end-to-end metrics, and the count of completed units the per-layer
    metrics divide by."""

    attempted: int
    failed: int
    seconds: float
    done: int
    metrics: dict[str, float]


class Context:
    """What a cell's driver gets: its workload and configuration files, the
    seed, the device, its scratch directory and the spans."""

    def __init__(self, workload: dict, config: dict, seed: int, device: torch.device, workdir: str, spans):
        self.workload = workload
        self.config = config
        self.params = dict(workload["params"])
        self.limits = dict(workload["limits"])
        self.seed = int(seed)
        self.device = device
        self.workdir = workdir
        self.spans = spans
        self._last = time.perf_counter()
        os.makedirs(workdir, exist_ok=True)

    def stage(self, name: str) -> None:
        """Print on stderr the seconds set-up spent since the last stage."""
        now = time.perf_counter()
        print(f"set-up: {name} {now - self._last:.3f} s", file=sys.stderr)
        self._last = now

    @property
    def net(self) -> dict:
        return self.config["net"]

    def sub(self, name: str) -> str:
        path = os.path.join(self.workdir, name)
        os.makedirs(path, exist_ok=True)
        return path


def judged_run(cell_def: dict, config: dict, seed: int, device: torch.device, seconds: float, fault=None,
               control: bool = False) -> tuple[list[Check], dict | None]:
    """One cell set up, its window run with `fault` (a context manager of
    ``portbench.faults``) under the timed path, its state released, and
    judged: the program's compared numbers, or with `control` the
    control's, with the cell's ``details``. No spans, no trace, and the
    card is not looked for."""
    from portbench.common.spans import Spans
    from portbench.common.weights import scratch_dir

    driver = importlib.import_module(f"portbench.drivers.{cell_def['driver']}")
    workdir = scratch_dir(f"portbench_{cell_def['name']}_")
    try:
        cell = driver.Cell(Context(cell_def, config, seed, device, workdir, Spans(False, device)))
        with fault() if fault else contextlib.nullcontext():
            cell.setup()
            cell.window(seconds)
        cell.release()
        checks = cell.control() if control else cell.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return checks, getattr(cell, "details", None)
