"""Without a card the command fails and prints no result; so it does in a
directory that holds only the benchmark; on the card, a short run of each
cell gives a correct result (marked ``cuda``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, *extra: str, seconds: str = "1") -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "portbench/run.py", "--workload", "cli_dir1080_b8", "--seed", "3000000007",
           "--seconds", seconds, "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=900)


def _json_lines(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith("{")]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _json_lines(proc.stdout)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and portbench/ without the rest of the checkout (the
    program, the photo material): no result, whether the card is looked
    for first or not."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and not _json_lines(proc.stdout)
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from portbench.run import execute, load_cell; "
         "import torch; b, c, g = load_cell('cli_photo1080_b1'); "
         "execute(b, 'cli_photo1080_b1', c, g, 1, 1.0, False, torch.device('cpu'))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert probe.returncode != 0 and not _json_lines(probe.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cli_dir1080_b8", "aspp_dir1080_b8", "cli_photo1080_b1", "cli_train640_b8"])
def test_cell_runs_on_the_card(card, cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for trace in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3100000001", "--seconds", "5",
             "--trace", trace], cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
