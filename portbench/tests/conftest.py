"""Shared pieces of the benchmark's CPU tests: tiny sizes of each traffic,
and a cell driven on the CPU (the program's plain versions), the card's
look skipped."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "dir1080_b8": {"n_photos": 8, "width": 256, "height": 144, "max_size": 256, "batch_size": 4, "num_workers": 2},
    "photo1080_b1": {"n_photos": 3, "width": 640, "height": 360, "max_size": None, "capture_stride": 1},
    "train640_b8": {"n_photos": 12, "image_size": 64, "batch_size": 4, "num_workers": 2, "window_check_steps": 3},
}


def tiny_cell(name: str):
    from portbench.run import load_cell

    bench, cell, config = load_cell(name)
    cell["params"] = dict(TINY[cell["traffic"]])
    return bench, cell, config


def drive(name: str, seed: int, fault=None, control: bool = False, seconds: float = 0.5):
    """Set up, run and judge cell `name` on the CPU at its tiny size, with
    `fault` (a context manager of ``portbench.faults``) under the timed
    path; the control in the program's place with `control`. Returns the
    compared numbers as {name: (value, ok)}."""
    import torch

    from portbench.common.cellbase import judged_run

    _bench, cell_def, config = tiny_cell(name)
    checks, _details = judged_run(cell_def, config, seed, torch.device("cpu"), seconds, fault, control)
    return {c.name: (c.value, c.ok) for c in checks}


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)
