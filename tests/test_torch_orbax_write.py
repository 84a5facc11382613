"""The port's trainer writes the JAX package's Orbax checkpoints
(``train/orbax.write_orbax``, ``train/checkpoint.save_checkpoint``), held to
orbax, zstandard and the JAX package on the CPU.

The run here is the CLI default net (no pre-activation, no ASPP) with
``grad_accum`` 1: tests/test_torch_train_step.py's seeded net takes two of
the port's steps at [2,32,32,3] (perceptual loss off, so no VGG19) and
``save_checkpoint`` writes ``latest`` and ``best``.
tests/test_torch_orbax_write_aspp.py runs the same checks on the
pre-activation + ASPP net with ``grad_accum`` 2, ending on a pending
micro-step. The checks (helpers here, used by both files):

- the JAX package's ``load_checkpoint`` restores the directory into its own
  template: every leaf of its ``_state_to_pytree`` equals ``state_to_tree``
  of the port's state bit for bit, and (start_epoch, best_loss) are the
  port's;
- orbax's metadata of the directory (``_METADATA``'s key paths and value
  types, each array's dtype and shape) equals that of the directory the
  JAX package's ``save_checkpoint`` writes after its next step;
- the JAX package's next step from the restored state matches the port's
  next step by tests/test_torch_train_step.py's rules (losses rtol 1e-4 /
  atol 1e-5, BatchNorm statistics atol 1e-4, Adam's moments 1e-2 and 2e-2
  of each leaf's largest, floored at 1e-3 of the tree's, or for an
  accumulated update 1e-3 and 2e-3 of the tree's largest, that file's rule
  for its ``grad_accum=2`` step; the parameters by
  tests/test_torch_orbax_resume.py's rule for an Adam step past the
  first);
- port to port: ``read_orbax`` returns every leaf bit for bit,
  ``load_checkpoint`` restores the whole state (the dropout generator's
  state and ``extra`` from the side file), and the next step is
  bit-identical to the uninterrupted run's.

Here too: both CLIs' ``--mode predict`` and ``--mode enhance`` from
``<save_dir>/best`` at ``--max_size 64`` (identical PNGs), the JAX package's ``scripts/export_serving.py`` on it, both
packages' ``load_params_for_inference``; a write that fails midway, the
swap without ``renameat2``, a torch file of the earlier format replaced and
still read; the stored zstd frames against zstandard; ``write_orbax`` of a
tree of every dtype against orbax's restore.
"""

import copy
import json
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import zstandard
from PIL import Image

from retinex_tpu import cli as jax_cli
from retinex_tpu.config import Config as JConfig
from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.checkpoint import _state_to_pytree
from retinex_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from retinex_tpu.train.checkpoint import load_params_for_inference as jax_load_params
from retinex_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retinex_tpu.train.train_state import make_train_step
from retinex_tpu.train.trainer import build_criterion as jax_build_criterion
from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import adam_state_to_optax, state_dict_to_variables
from retinex_tpu_torch.train import checkpoint as port_ckpt
from retinex_tpu_torch.train import orbax as port_orbax
from retinex_tpu_torch.train.checkpoint import (
    SIDE_FILE,
    load_checkpoint,
    load_params_for_inference,
    save_checkpoint,
    state_to_tree,
)
from retinex_tpu_torch.train.orbax import read_orbax, write_orbax, zstd_decompress, zstd_stored
from retinex_tpu_torch.train.train_state import create_train_state, train_step
from retinex_tpu_torch.train.trainer import build_criterion
from test_torch_orbax import same_as_orbax
from test_torch_orbax_resume import adam_update, params_close_adam
from test_torch_train_step import LR, adam_of, batches, floor_of, jax_state, losses_close, port_model, tree_close

REPO = Path(__file__).resolve().parent.parent
EPOCH, BEST = 3, 0.375
SEED = 4  # the port's dropout generator
# name: (use_preact, use_aspp, grad_accum, the port's steps before the save)
RUNS = {"cli": (False, False, 1, 2), "preact_aspp": (True, True, 2, 3)}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jtu.tree_map(np.asarray, tree)


def flat(tree) -> dict:
    """{key path as names: leaf} of a JAX or a port tree (dict keys,
    namedtuple fields and sequence indices alike)."""
    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    return {tuple(name(k) for k in path): leaf for path, leaf in jtu.tree_flatten_with_path(tree)[0]}


def fresh_state(name: str, model=None):
    """A port train state of another seed than the run's, to restore into."""
    preact, aspp, accum, _ = RUNS[name]
    model = port_model(preact, aspp, seed=7) if model is None else model
    return create_train_state(model, lambda s: LR, seed=99, grad_accum=accum)


def port_run(name: str, root: Path) -> dict:
    """The port's steps, the save (``latest`` and ``best``), what was saved,
    the uninterrupted next step, and the JAX package's restore, next step
    and own save after it."""
    preact, aspp, accum, steps = RUNS[name]
    crit = build_criterion(Config(use_preact=preact, use_aspp=aspp, use_perceptual_loss=False), torch.device("cpu"))
    state = create_train_state(port_model(preact, aspp), lambda s: LR, seed=SEED, grad_accum=accum)
    xs = batches(steps + 1, seed=21)
    for x in xs[:steps]:
        train_step(state, crit, torch.from_numpy(x))
    save_dir = root / name
    extra = {"loader_rng": {"state": 123, "inc": 7}, "aug_rng": torch.arange(5, dtype=torch.uint8)}
    nbytes = save_checkpoint(state, str(save_dir), EPOCH, BEST, is_best=True, extra=extra)
    saved = jtu.tree_map(np.copy, state_to_tree(state, EPOCH, BEST))  # on the CPU it shares the tensors' memory
    gen = state.dropout_gen.get_state().clone()
    next_losses = train_step(state, crit, torch.from_numpy(xs[steps]))
    jnet = JNet(use_preact=preact, use_aspp=aspp)
    template = jax_state(port_model(preact, aspp, seed=7), accum, aspp)
    jstate, jepoch, jbest = jax_load_checkpoint(template, str(save_dir / "latest"))
    jstep = make_train_step(jnet, jax_build_criterion(JConfig(use_preact=preact, use_aspp=aspp,
                                                              use_perceptual_loss=False)), donate=False)
    after, jlosses = jstep(jstate, jnp.asarray(xs[steps]))
    jax_save_checkpoint(after, str(root / f"{name}_jax"), EPOCH, BEST, is_best=False)
    return dict(name=name, crit=crit, x=xs[steps], dir=save_dir, bytes=nbytes, saved=saved, gen=gen, extra=extra,
                next_state=state, next_losses=next_losses, jnet=jnet, jstate=jstate, jepoch=jepoch, jbest=jbest,
                after=after, jlosses=jlosses, jax_dir=root / f"{name}_jax" / "latest")


# ---- the checks, shared with tests/test_torch_orbax_write_aspp.py ---------------------------


def check_jax_restores_bit_for_bit(run) -> None:
    assert (run["jepoch"], run["jbest"]) == (EPOCH + 1, BEST)
    got = flat(_np(_state_to_pytree(run["jstate"], EPOCH, BEST)))
    want = flat(run["saved"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if path == ("step",):  # the template's step is create_train_state's Python int, which orbax keeps
            assert int(g) == int(w) == RUNS[run["name"]][3], g
            continue
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), path
    key = np.asarray(jax.random.key_data(run["jstate"].dropout_rng))
    assert key.dtype == np.uint32 and int.from_bytes(key.tobytes(), "little") == SEED


def _metadata(path) -> dict:
    meta = json.loads((Path(path) / "_METADATA").read_text())
    arrays = ocp.StandardCheckpointer().metadata(path).item_metadata.tree
    shapes = {k: (str(v.dtype), tuple(v.shape)) for k, v in flat(arrays).items() if hasattr(v, "dtype")}
    return {"format": {k: v for k, v in meta.items() if k != "tree_metadata"},
            "tree": meta["tree_metadata"], "arrays": shapes}


def check_metadata_matches_jax(run) -> None:
    got, want = _metadata(run["dir"] / "latest"), _metadata(run["jax_dir"])
    assert got["format"] == want["format"]
    assert got["tree"].keys() == want["tree"].keys()
    for k, w in want["tree"].items():
        assert got["tree"][k] == w, k  # key types, value type, write shape
    assert got["arrays"] == want["arrays"] and len(want["arrays"]) > 400


def check_next_step_matches_jax(run, port_state) -> None:
    """The JAX package's step from the restored state against the port's
    from `port_state` (restored from the same directory)."""
    aspp = RUNS[run["name"]][1]
    after = run["after"]
    losses_close(train_step(port_state, run["crit"], torch.from_numpy(run["x"])), run["jlosses"], "the next step")
    assert port_state.step == int(after.step)
    got = state_dict_to_variables(port_state.model.state_dict(), aspp)
    tree_close(got["batch_stats"], _np(after.batch_stats), "batch_stats", atol=1e-4)
    adam = adam_of(after.opt_state)
    opt = port_state.optimizer
    mu, nu, count = adam_state_to_optax({"mu": opt.mu, "nu": opt.nu, "count": opt.count}, aspp)
    want_mu, want_nu = _np(adam.mu), _np(adam.nu)
    assert count == int(adam.count)
    if opt.grad_accum > 1:  # the accumulated update: that file's rule for its grad_accum=2 step
        assert opt.mini_step == int(after.opt_state.mini_step) == 0
        tree_close(mu, want_mu, "mu", atol=floor_of(want_mu))
        tree_close(nu, want_nu, "nu", atol=2 * floor_of(want_nu))
    else:
        tree_close(mu, want_mu, "mu", rel=1e-2)
        tree_close(nu, want_nu, "nu", rel=2e-2)
    params_close_adam(got["params"], _np(after.params), adam_update(mu, nu, count),
                      adam_update(want_mu, want_nu, count), "params")


def check_port_round_trip(run) -> None:
    path = str(run["dir"] / "latest")
    assert same_as_orbax(read_orbax(path), run["saved"]) > 400
    back, epoch, best, extra = load_checkpoint(fresh_state(run["name"]), path)
    assert (epoch, best) == (EPOCH + 1, BEST)
    assert extra.keys() == run["extra"].keys() and extra["loader_rng"] == run["extra"]["loader_rng"]
    assert torch.equal(extra["aug_rng"], run["extra"]["aug_rng"])
    assert same_as_orbax(jtu.tree_map(np.copy, state_to_tree(back, EPOCH, BEST)), run["saved"]) > 400
    assert torch.equal(back.dropout_gen.get_state(), run["gen"])
    losses = train_step(back, run["crit"], torch.from_numpy(run["x"]))
    assert all(torch.equal(losses[k], run["next_losses"][k]) for k in losses)
    assert same_as_orbax(state_to_tree(back, EPOCH, BEST), state_to_tree(run["next_state"], EPOCH, BEST)) > 400


# ---- the CLI default net, grad_accum 1 ---------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return port_run("cli", tmp_path_factory.mktemp("orbax_write"))


def test_jax_load_checkpoint_restores_the_port_checkpoint_bit_for_bit(run):
    check_jax_restores_bit_for_bit(run)
    assert sorted(os.listdir(run["dir"])) == ["best", "latest"]
    assert sorted(os.listdir(run["dir"] / "latest")) == sorted(
        ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt", SIDE_FILE])
    print(f"the CLI default net's checkpoint: {run['bytes']} bytes")
    assert 51e6 < run["bytes"] < 52e6  # 4,275,475 parameters, Adam's two moments, f32, stored


def test_orbax_metadata_matches_a_jax_written_checkpoint(run):
    check_metadata_matches_jax(run)


def test_the_jax_next_step_matches_the_ports(run):
    back, _, _, _ = load_checkpoint(fresh_state("cli"), str(run["dir"] / "latest"))
    check_next_step_matches_jax(run, back)


def test_port_to_port_is_exact(run):
    check_port_round_trip(run)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("mode", ["predict", "enhance"])
def test_both_clis_agree_on_the_port_checkpoint(run, tmp_path, mode, capsys):
    """The PNGs are identical (tests/test_torch_orbax_cli.py allows 1 and 2
    levels on the fixture, whose weights are all +-1/sqrt(fan_in); on this
    checkpoint no byte differs, measured on the CPU)."""
    photo = REPO / "data" / "convergence" / "lowlight_004.png"
    best = str(run["dir"] / "best")
    args = ["--mode", mode, "--input_path", str(photo), "--max_size", "64", "--checkpoint", best]
    jax_cli.main([*args, "--output_dir", str(tmp_path / "jax")])
    cli.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert f"Loaded checkpoint {best} (Orbax)" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 3
    for name in names:
        got, want = _png(tmp_path / "port" / name), _png(tmp_path / "jax" / name)
        d = np.abs(got - want)
        what = f"{mode} {name}: max {d.max()}, {(d > 0).mean():.2e} of bytes differ"
        print(what)
        assert got.shape == want.shape and d.max() == 0, what


def test_jax_export_and_both_load_params_for_inference(run, tmp_path, monkeypatch, capsys):
    best = str(run["dir"] / "best")
    want = jax_load_params(best)
    got = load_params_for_inference(best)
    assert same_as_orbax(got, {"params": want["params"], "batch_stats": want["batch_stats"]}) == 145 + 38
    assert same_as_orbax(got, {k: run["saved"][k] for k in ("params", "batch_stats")}) == 145 + 38
    out = tmp_path / "predict.shlo"
    monkeypatch.setattr(sys, "argv", ["export_serving.py", "--checkpoint", best, "--height", "32", "--width", "32",
                                      "--out", str(out), "--pipeline", "predict"])
    runpy.run_path(str(REPO / "scripts" / "export_serving.py"), run_name="__main__")
    assert f"wrote {out}" in capsys.readouterr().out and out.stat().st_size > 1e6


# ---- safe writes and the earlier format -------------------------------------------------------


def _small_state(seed: int):
    state = fresh_state("cli", port_model(False, False, seed=seed))
    with torch.no_grad():
        state.optimizer.mu["fusion.weight"].fill_(seed)
    state.step = seed
    return state


def test_an_interrupted_write_leaves_the_previous_latest(tmp_path, monkeypatch):
    first = _small_state(1)
    save_checkpoint(first, str(tmp_path), 0, 1.0, is_best=True)
    want = jtu.tree_map(np.copy, state_to_tree(first, 0, 1.0))
    calls = {"n": 0}
    real = port_orbax.zstd_stored

    def failing(data):
        calls["n"] += 1
        if calls["n"] == 200:
            raise OSError("disk full")
        return real(data)

    monkeypatch.setattr(port_orbax, "zstd_stored", failing)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(_small_state(2), str(tmp_path), 1, 0.5, is_best=True)
    assert calls["n"] == 200 and sorted(os.listdir(tmp_path)) == ["best", "latest"]
    for name in ("latest", "best"):
        assert same_as_orbax(read_orbax(str(tmp_path / name)), want) > 400
    # A crash after the data is written but before the swap: the same.
    def crash(new, path):
        raise KeyboardInterrupt

    monkeypatch.setattr(port_orbax, "zstd_stored", real)
    monkeypatch.setattr(port_ckpt, "_swap_in", crash)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(_small_state(3), str(tmp_path), 2, 0.25, is_best=False)
    assert same_as_orbax(read_orbax(str(tmp_path / "latest")), want) > 400
    assert load_checkpoint(fresh_state("cli"), str(tmp_path / "latest"))[0].step == 1


def test_the_swap_without_renameat2_and_over_a_torch_file(tmp_path, monkeypatch):
    """Where the exchange is missing, two renames; a torch file of the
    earlier format at ``latest`` is replaced by the directory."""
    state = _small_state(4)
    (tmp_path / "latest").write_bytes(b"an earlier torch file")
    save_checkpoint(state, str(tmp_path), 5, 0.5, is_best=False)
    assert (tmp_path / "latest" / "_METADATA").is_file()
    monkeypatch.setattr(port_ckpt, "_exchange", lambda a, b: False)
    state.step = 6
    save_checkpoint(state, str(tmp_path), 6, 0.5, is_best=False)
    assert sorted(os.listdir(tmp_path)) == ["latest"]
    assert read_orbax(str(tmp_path / "latest"))["step"] == 6


def test_a_side_file_of_another_device_type_is_set_aside(tmp_path):
    """A card's checkpoint resumed on the CPU: its generators' states are
    of another kind, so the dropout generator is seeded from the tree and
    ``extra`` is empty, as from a JAX-written directory."""
    state = _small_state(6)
    torch.rand(3, generator=state.dropout_gen)  # its state now differs from its seed's
    save_checkpoint(state, str(tmp_path), 0, 1.0, is_best=False, extra={"k": 1})
    side_path = tmp_path / "latest" / SIDE_FILE
    side = torch.load(side_path, weights_only=True)
    torch.save({**side, "device": "cuda"}, side_path)
    back, _, _, extra = load_checkpoint(fresh_state("cli"), str(tmp_path / "latest"))
    seeded = torch.Generator().manual_seed(state.dropout_gen.initial_seed()).get_state()
    assert extra == {} and torch.equal(back.dropout_gen.get_state(), seeded)
    assert not torch.equal(seeded, state.dropout_gen.get_state())
    torch.save(side, side_path)
    back, _, _, extra = load_checkpoint(fresh_state("cli"), str(tmp_path / "latest"))
    assert extra == {"k": 1} and torch.equal(back.dropout_gen.get_state(), state.dropout_gen.get_state())


def test_a_torch_file_of_the_earlier_format_still_loads(tmp_path):
    """The single-file checkpoint the port wrote before it wrote
    directories (its keys as that writer put them)."""
    state = _small_state(5)
    state.loss_state.prev.fill_(0.5)
    old = {
        "epoch": 2, "model_state_dict": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
        "loss_state": {"prev": state.loss_state.prev, "prev2": state.loss_state.prev2, "step": state.loss_state.step},
        "dropout_rng": state.dropout_gen.get_state(), "step": 5, "best_loss": 0.5, "extra": {"k": 1},
    }
    torch.save(old, tmp_path / "latest")
    back, epoch, best, extra = load_checkpoint(fresh_state("cli"), str(tmp_path / "latest"))
    assert (epoch, best, extra, back.step) == (3, 0.5, {"k": 1}, 5)
    assert same_as_orbax(state_to_tree(back, 2, 0.5), state_to_tree(state, 2, 0.5)) > 400


# ---- the pieces ----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 131071, 131072, 131073, 400_000])
def test_stored_zstd_frames_decode(n):
    data = np.random.default_rng(n).bytes(n)
    frame = zstd_stored(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data == zstd_decompress(frame)
    assert zstandard.frame_content_size(frame) == n
    assert len(frame) - n == 4 + 1 + (1 if n < 256 else 2 if n < 65792 else 4) + 3 * max(1, -(-n // 131072))


def test_write_orbax_of_every_dtype_equals_orbax_restore(tmp_path):
    rng = np.random.default_rng(3)
    tree = {
        "f32": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)},
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4), "i64": np.asarray(2**40 + 3, np.int64),
        "f64": np.asarray(-1.25e-300, np.float64), "u32": np.array([928981903, 3453687069], np.uint32),
        "u8": np.arange(7, dtype=np.uint8), "py_int": 5, "py_float": 0.5,
        "big": rng.standard_normal(300_000).astype(np.float32),
        "seq": [np.ones(2, np.float32), {"a": np.zeros(3, np.int32)}], "none": None, "empty_dict": {},
        "empty_tuple": (), "empty_list": [],
    }
    path = tmp_path / "tree"
    n = write_orbax(str(path), tree, numpy_keys=[("i64",)])
    assert n == sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
    want = ocp.StandardCheckpointer().restore(path)
    got = read_orbax(str(path))
    # 16 entries in _METADATA; same_as_orbax counts the empty tuple and list as no leaf
    assert len(json.loads((path / "_METADATA").read_text())["tree_metadata"]) == 16
    assert same_as_orbax(got, want) == same_as_orbax(got, tree) == 14
    types = {k: v["value_metadata"]["value_type"] for k, v in json.loads((path / "_METADATA").read_text())[
        "tree_metadata"].items()}
    assert (types["('i64',)"], types["('f32', 'kernel')"], types["('py_int',)"], types["('empty_tuple',)"]) == (
        "np.ndarray", "jax.Array", "scalar", "Tuple")
    store = port_orbax.read_ocdbt(str(path))
    assert isinstance(store["big/0"], tuple) and isinstance(store["i32/0.0"], bytes)  # data file / inline
    with pytest.raises(TypeError, match="str"):
        write_orbax(str(tmp_path / "bad"), {"a": "text"})
    with pytest.raises(FileExistsError):
        write_orbax(str(path), tree)
    template = jtu.tree_map(jnp.asarray, {k: tree[k] for k in ("f32", "u32", "big")})
    restored = ocp.StandardCheckpointer().restore(path, {**copy.deepcopy(want), **template})
    assert same_as_orbax(_np({k: restored[k] for k in template}), {k: tree[k] for k in template}) == 4
