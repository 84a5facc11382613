"""Several hosts, several ranks each, on ``torch.distributed`` over gloo:
the port's counterpart of tests/test_multihost.py.

Two processes stand for two hosts. Each runs ``parallel/distributed.launch``
with ``--coordinator 127.0.0.1:<port> --num_processes 2 --process_id i
--n_devices 4``, so it starts 2 local ranks, global ranks 2i and 2i+1 of a
world of 4 (the JAX test's 2 processes of 2 devices, a mesh of 4). The
processes and their ranks import only ``torch`` and the port.

- the global mean of a batch whose rows are spread over the 4 ranks
  (tests/test_multihost.py:20-69);
- the preemption agreement: one rank sees the flag at batch 3 and every rank
  stops there (tests/test_multihost.py:127-187);
- the loader's process shards equal the JAX package's (same images in every
  batch), with no process;
- one ``--mode train`` epoch through the CLI on 2 CPU ranks writes one
  checkpoint that ``--mode predict`` loads, and its epoch loss equals the
  one-device run's.
"""

import csv
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys

import torch

from retinex_tpu_torch.config import Config
from retinex_tpu_torch.parallel import distributed as d


def global_mean():
    rank, world = d.data_shard()
    assert world == 4 and d.process_shard() == (rank // 2, 2) and d.local_shard() == (rank % 2, 2)
    assert d.local_batch_size(8) == 4
    ids = torch.arange(8, dtype=torch.float32)
    mine = ids[rank * 2 : (rank + 1) * 2]  # global batch 8: 4 per process, 2 per rank
    batch = mine[:, None].repeat(1, 16)
    out = float(d.global_mean(batch * batch))
    want = float((ids[:, None].repeat(1, 16) ** 2).mean())
    assert abs(out - want) < 1e-5, (out, want)
    return f"rank {rank}: global mean {out:.4f}"


def preemption():
    rank, _world = d.data_shard()
    stopped = None
    for batch_idx in range(10):
        if d.any_over_ranks(rank == 1 and batch_idx == 3, torch.device("cpu")):
            stopped = batch_idx
            break
    assert stopped == 3, stopped
    return f"rank {rank}: agreed stop at batch {stopped}"


if __name__ == "__main__":
    process_id, coordinator, what = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    config = Config(device="cpu", coordinator=coordinator, num_processes=2, process_id=process_id, n_devices=4)
    assert d.world_plan(config) == (process_id, 2, 2)
    print(f"OK process {process_id}: " + d.launch({"mean": global_mean, "preempt": preemption}[what], (), config, 2))
    assert "jax" not in sys.modules and "retinex_tpu" not in sys.modules
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("what,line", [("mean", "global mean 17.5000"), ("preempt", "agreed stop at batch 3")])
def test_two_hosts_of_two_ranks(tmp_path, what, line):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), coordinator, what],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(tmp_path),
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"OK process {pid}: rank {2 * pid}: {line}" in out, out


def test_loader_shards_match_jax(tmp_path):
    """Every process shuffles with the same seed, takes its stride and
    truncates to a common length: the same images as the JAX package's
    loader, batch by batch, on each shard; the rows option splits them."""
    from retinex_tpu.data.dataset import get_train_loader as jax_loader
    from retinex_tpu_torch.data.dataset import get_train_loader

    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(11):
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(d / f"im{i:02d}.png")
    knobs = dict(batch_size=2, image_size=8, shuffle=True, drop_last=True, seed=3)
    seen = []
    for shard in ((0, 2), (1, 2), (0, 1)):
        for epoch in range(2):
            lo, jlo = get_train_loader(str(d), shard=shard, **knobs), jax_loader(str(d), shard=shard, **knobs)
            for _ in range(epoch):  # the second epoch's order
                list(lo), list(jlo)
            got, want = list(lo), list(jlo)
            assert len(lo) == len(jlo) == len(got) == len(want) == (5 if shard[1] == 1 else 2)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            if shard[1] == 2 and epoch == 0:
                seen.append(np.concatenate(got))
            rows = [get_train_loader(str(d), shard=shard, rows=(r, 2), **knobs) for r in (0, 1)]
            for _ in range(epoch):
                [list(r) for r in rows]
            for full, halves in zip(want, zip(*[list(r) for r in rows])):
                np.testing.assert_array_equal(np.concatenate(halves), full)
    # The two shards' first epochs share no image.
    flat = [x.tobytes() for s in seen for x in s]
    assert len(set(flat)) == len(flat) == 8


def _cli(*args, cwd) -> str:
    out = subprocess.run([sys.executable, "-m", "retinex_tpu_torch.cli", *args], capture_output=True, text=True,
                         env=_env(), cwd=cwd, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_train_on_two_ranks_then_predict(tmp_path):
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    for i in range(8):
        name = f"lowlight_{i:03d}.png"
        Image.open(REPO / "data" / "convergence" / name).convert("RGB").resize((48, 48)).save(train_dir / name)
    base = ["--mode", "train", "--train_dir", str(train_dir), "--image_size", "32", "--batch_size", "4",
            "--num_epochs", "1", "--no-use_perceptual_loss", "--no-progress_bar", "--device", "cpu"]
    two = _cli(*base, "--save_dir", str(tmp_path / "two"), "--n_devices", "2", cwd=tmp_path)
    one = _cli(*base, "--save_dir", str(tmp_path / "one"), cwd=tmp_path)
    assert "Data parallel: 2 rank(s), 2 on this host" in two and "(rank 0 of 2)" in two
    assert two.count("Epoch 0:") == 1  # the other rank prints nothing
    assert sorted(p.name for p in (tmp_path / "two").iterdir() if p.is_file()) == ["best", "latest", "results.csv"]

    def total(run):
        with open(tmp_path / run / "results.csv", newline="") as f:
            return float(next(csv.DictReader(f))["total"])

    assert total("two") == pytest.approx(total("one"), rel=1e-5)
    out = tmp_path / "pred"
    _cli("--mode", "predict", "--checkpoint", str(tmp_path / "two" / "best"), "--input_path",
         str(train_dir / "lowlight_000.png"), "--output_dir", str(out), "--max_size", "64", "--device", "cpu",
         cwd=tmp_path)
    assert sorted(os.listdir(out)) == [f"lowlight_000_{k}.png" for k in ("comparison", "enhanced", "illumination")]
