"""The port's training loop on the CPU: files written, exact checkpoints
(Orbax directories) and resume, a falling loss, SIGTERM, and inference from
the trained checkpoint. Counterpart of tests/test_train_loop.py,
test_checkpoint.py and test_preemption.py. The JAX package is imported by
one test only, to read a checkpoint's parameters."""

import copy
import csv
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import variables_to_state_dict
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.train.checkpoint import (
    SIDE_FILE,
    load_checkpoint,
    load_params_for_inference,
    save_checkpoint,
    state_dict_for,
)
from retinex_tpu_torch.train.orbax import OrbaxFormatError, read_orbax
from retinex_tpu_torch.train.train_state import create_train_state, train_step
from retinex_tpu_torch.train.trainer import build_criterion, train
from retinex_tpu_torch.utils.viz import create_gif

REPO = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers,
    and PyTorch's default of one thread per core oversubscribes the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)



@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_imgs")
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray((rng.random((40, 50, 3)) * 80).astype(np.uint8)).save(d / f"img_{i}.png")
    return str(d)


def _config(tiny_dataset, save_dir, **overrides) -> Config:
    base = dict(
        mode="train", train_dir=tiny_dataset, save_dir=str(save_dir), num_epochs=2, batch_size=2, image_size=32,
        lr=1e-3, num_workers=2, patience=50, log_every=1, save_freq=1, device="cpu", progress_bar=False,
    )
    base.update(overrides)
    return Config(**base)


def _same_state(a, b, what: str = ""):
    """Bit for bit: nested dicts and lists of tensors, numpy arrays and
    plain values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _same_state(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what
    else:
        assert a == b, f"{what}: {a} != {b}"


def _ckpt(path):
    """A checkpoint directory: its Orbax tree and its side file."""
    side = torch.load(os.path.join(path, SIDE_FILE), map_location="cpu", weights_only=True)
    return {"tree": read_orbax(str(path)), "side": side}


def test_train_two_epochs_writes_checkpoints_and_logs(tiny_dataset, tmp_path, capsys):
    cfg = _config(tiny_dataset, tmp_path / "ckpt", use_freq_loss=True)
    result = train(cfg)
    out = capsys.readouterr().out
    assert result["epochs_run"] == 2 and np.isfinite(result["best_loss"])
    assert "5 images, 2 batches/epoch (1 re-shuffled into later epochs)" in out
    assert "Epoch 0: time" in out and "Epoch 1: time" in out and "using the standard step" in out
    for name in ("best", "latest"):
        assert os.path.isfile(os.path.join(cfg.save_dir, name, "_METADATA")), name
    assert os.path.isfile(os.path.join(cfg.save_dir, "results.csv"))
    (log_dir,) = os.listdir(os.path.join(cfg.save_dir, "logs"))
    with open(os.path.join(cfg.save_dir, "logs", log_dir, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"Loss/total", "Epoch_Loss/total", "Learning_Rate", "Epoch_Loss/frequency"} <= tags
    with open(os.path.join(cfg.save_dir, "results.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"] and float(rows[0]["frequency"]) > 0
    vis = sorted(os.listdir(os.path.join(cfg.save_dir, "visualizations")))
    assert vis[0] == "epoch_0_batch_0_sample_0.png" and len(vis) == 8
    with Image.open(os.path.join(cfg.save_dir, "visualizations", vis[0])) as im:
        assert im.size == (96, 32)
    ck = _ckpt(os.path.join(cfg.save_dir, "latest"))["tree"]
    assert ck["epoch"] == 1 and ck["step"] == 4 and ck["opt_state"][2]["count"] == 4
    gif = os.path.join(cfg.save_dir, "samples.gif")
    create_gif([os.path.join(cfg.save_dir, "visualizations", v) for v in vis[:3]], gif)
    with Image.open(gif) as im:
        assert im.n_frames == 3


def test_checkpoint_round_trip_is_exact(tmp_path):
    """Every part of the state survives save and load; the parameters read
    the same through both packages' load_params_for_inference."""
    from retinex_tpu.train.checkpoint import load_params_for_inference as jax_load_params

    cfg = Config(use_aspp=True, use_preact=True, use_perceptual_loss=False, adaptive_weights=True, grad_accum=2)
    crit = build_criterion(cfg, torch.device("cpu"))

    def fresh():
        m = init_untrained(MultiScaleUPRetinex(use_preact=True, use_aspp=True), 3)
        return create_train_state(m, lambda s: 1e-3, seed=4, grad_accum=2)

    state = fresh()
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    for _ in range(3):  # one applied update and a pending micro-step
        train_step(state, crit, x)
    save_checkpoint(state, str(tmp_path), epoch=7, best_loss=0.25, is_best=True, extra={"k": 1})
    back, start, best, extra = load_checkpoint(fresh(), str(tmp_path / "best"))
    assert (start, best, extra) == (8, 0.25, {"k": 1})
    _same_state(back.model.state_dict(), state.model.state_dict(), "model")
    _same_state(back.optimizer.state_dict(), state.optimizer.state_dict(), "optimizer")
    assert back.optimizer.mini_step == 1 and back.optimizer.count == 1 and back.step == 3
    for k in ("prev", "prev2", "step"):
        assert torch.equal(getattr(back.loss_state, k), getattr(state.loss_state, k)), k
    assert torch.equal(back.dropout_gen.get_state(), state.dropout_gen.get_state())
    params = load_params_for_inference(str(tmp_path / "latest"))
    _same_state(state_dict_for(back.model, params), state.model.state_dict(), "the parameters")
    want = jax_load_params(str(tmp_path / "latest"))
    _same_state(params, {"params": want["params"], "batch_stats": want["batch_stats"]}, "the JAX package's parameters")
    # Both go on identically, dropout draws included.
    a, b = train_step(state, crit, x), train_step(back, crit, x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    _same_state(back.model.state_dict(), state.model.state_dict(), "after a step")


def test_two_epochs_equal_one_epoch_and_a_resume(tiny_dataset, tmp_path):
    train(_config(tiny_dataset, tmp_path / "a", num_epochs=2, advanced_augment=True))
    train(_config(tiny_dataset, tmp_path / "b", num_epochs=1, advanced_augment=True))
    result = train(_config(tiny_dataset, tmp_path / "b", num_epochs=2, advanced_augment=True,
                           resume=str(tmp_path / "b" / "latest")))
    assert result["epochs_run"] == 2
    a, b = _ckpt(tmp_path / "a" / "latest"), _ckpt(tmp_path / "b" / "latest")
    assert a["side"]["extra"]["loader_rng"] and a["tree"]["step"] == 4
    _same_state(a, b, "latest")


def test_loss_falls_over_a_short_run(tiny_dataset, tmp_path):
    cfg = _config(tiny_dataset, tmp_path / "ckpt", num_epochs=4, lr=2e-3, use_perceptual_loss=False)
    train(cfg)
    with open(os.path.join(cfg.save_dir, "results.csv")) as f:
        totals = [float(r["total"]) for r in csv.DictReader(f)]
    assert len(totals) == 4 and totals[-1] < totals[0], totals


def test_early_stopping_and_unported_options(tiny_dataset, tmp_path):
    cfg = _config(tiny_dataset, tmp_path / "ckpt", num_epochs=5, lr=0.0, patience=1, use_perceptual_loss=False)
    assert train(cfg)["epochs_run"] < 5
    # Several devices and hosts run (tests/test_torch_multihost.py); their
    # options raise where they do not fit together, as the JAX package's do.
    for flags, match in (
        (dict(coordinator="localhost:1"), "--coordinator requires --num_processes and --process_id"),
        (dict(remat=True, coordinator="localhost:1", num_processes=2), "--coordinator requires"),
        (dict(coordinator="localhost:1", num_processes=2, process_id=2), "--process_id 2 is not in"),
        (dict(use_amp=True, n_devices=3, coordinator="localhost:1", num_processes=2, process_id=0), "does not split"),
        (dict(n_devices=0), "at least one device"),
    ):
        with pytest.raises(ValueError, match=match):
            train(_config(tiny_dataset, tmp_path / "x", **flags))


def _lines(proc, until, timeout):
    """Read the child's stdout until a line starts with `until`."""
    import queue
    import threading

    q = queue.Queue()
    threading.Thread(target=lambda: [q.put(line) for line in proc.stdout] and q.put(None), daemon=True).start()
    seen, deadline = [], time.time() + timeout
    while time.time() < deadline:
        try:
            line = q.get(timeout=1.0)
        except queue.Empty:
            continue
        if line is None:
            break
        seen.append(line)
        if line.startswith(until):
            return seen, True, q
    return seen, False, q


def _cli(train_dir, save_dir, *extra):
    code = (
        "import sys; from retinex_tpu_torch.cli import main; "
        f"main(['--mode', 'train', '--train_dir', {train_dir!r}, '--save_dir', {str(save_dir)!r}, "
        "'--num_epochs', '500', '--batch_size', '2', '--image_size', '32', '--device', 'cpu', "
        f"'--no-use_perceptual_loss', '--no-progress_bar'{''.join(f', {e!r}' for e in extra)}])"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-u", "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=str(REPO))


def test_sigterm_writes_latest_and_exits_zero(tiny_dataset, tmp_path):
    save_dir = tmp_path / "ckpt"
    proc = _cli(tiny_dataset, save_dir)
    try:
        seen, ok, q = _lines(proc, "Epoch 0:", 120)
        assert ok, "".join(seen)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
    rest = []
    while not q.empty():
        rest.append(q.get() or "")
    text = "".join(seen + rest)
    assert "Preemption checkpoint written" in text, text
    ck = _ckpt(save_dir / "latest")["tree"]
    assert ck["step"] >= 2 * (ck["epoch"] + 1) + 1  # the cut epoch ran at least one step
    # --resume from it starts where it was cut.
    proc = _cli(tiny_dataset, save_dir, "--resume", str(save_dir / "latest"))
    try:
        seen, ok, _ = _lines(proc, "Epoch ", 120)
        assert ok and any(line.startswith(f"Resumed from {save_dir / 'latest'} at epoch {ck['epoch'] + 1}")
                          for line in seen), "".join(seen)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()


def test_predict_and_enhance_load_the_trained_checkpoint(tiny_dataset, tmp_path):
    save_dir = tmp_path / "ckpt"
    train(_config(tiny_dataset, save_dir, num_epochs=1, use_perceptual_loss=False))
    photo = os.path.join(tiny_dataset, "img_0.png")
    for mode in ("predict", "enhance"):
        out = tmp_path / mode
        cli.main(["--mode", mode, "--checkpoint", str(save_dir / "best"), "--input_path", photo,
                  "--output_dir", str(out), "--max_size", "64", "--device", "cpu"])
        assert sorted(os.listdir(out)) == ["img_0_comparison.png", "img_0_enhanced.png", "img_0_illumination.png"]
    model = cli.build_model(Config(checkpoint=str(save_dir / "best"), device="cpu"), torch.device("cpu"))
    trained = variables_to_state_dict(_ckpt(save_dir / "best")["tree"], False, False)
    assert all(torch.equal(v, trained[k]) for k, v in model.state_dict().items())
    assert not torch.equal(model.state_dict()["fusion.weight"],
                           init_untrained(copy.deepcopy(model), 0).state_dict()["fusion.weight"])
    # A directory: the JAX package's Orbax checkpoint (the committed fixture of
    # tests/test_torch_orbax.py) loads; one that is not such a checkpoint raises.
    fixture = REPO / "tests" / "fixtures" / "orbax_jax" / "latest"
    jax_trained = cli.build_model(Config(checkpoint=str(fixture), device="cpu"), torch.device("cpu"))
    assert all(torch.equal(v, want) for v, want in zip(
        jax_trained.state_dict().values(), state_dict_for(jax_trained, load_params_for_inference(str(fixture))).values()))
    assert not torch.equal(jax_trained.state_dict()["fusion.weight"], model.state_dict()["fusion.weight"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(OrbaxFormatError, match="not an Orbax checkpoint"):
        cli.build_model(Config(checkpoint=str(tmp_path / "orbax")), torch.device("cpu"))
