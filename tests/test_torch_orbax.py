"""The port's reader of the JAX package's Orbax checkpoints, on the CPU,
held to zstandard, orbax and the JAX package (which only the tests import).

(a) ``csrc/zstd_decode.cpp`` (``train/orbax.zstd_decompress``) against
    zstandard, byte for byte: levels 1, 3 and 19 on empty input, one byte,
    1 MB of random bytes, zeros, repetitive text and a float32 weight
    array; frames without a content size (streamed), with a checksum, two
    frames one after another and skippable frames, content over the 128 KB
    block maximum. Every truncation raises; a flipped bit in a checksummed
    frame raises or leaves the bytes exact; a dictionary raises.
(b) ``read_orbax`` against orbax's own restore, bit for bit, on trees
    written here by orbax: f32, bf16 (returned as the f32 of the same
    value), i32, i64, f64 and u32 leaves, scalars, a 300k-element array
    in a data file, an array sharded over the 8 CPU devices (8 chunks),
    empty containers, None, and 300 leaves. Orbax's own node limit (100 MB)
    never splits a train state's B-tree, so the same checkpoint is also
    re-packed by tensorstore with 4 KB nodes, which gives interior nodes.
    What orbax 0.11 does not write here raises.
(c) The committed fixture ``tests/fixtures/orbax_jax/latest``: the JAX
    package's ``save_checkpoint`` of ``create_train_state`` at the CLI
    defaults (the net without pre-activation or ASPP, PRNGKey(0), weight
    decay 1e-5, no accumulation; initialised at [1,64,64,3], which gives
    the same parameters as the CLI's [8,640,640,3]) with every params
    kernel sign x 1/sqrt(fan_in), written by ``write_orbax_fixture``. It
    equals chip_smoke.py's numpy regeneration and the writer's output; the
    port's ``load_params_for_inference`` and ``load_checkpoint`` equal the
    JAX package's on it; the CLI builds the net from it and refuses it for
    another net. A fresh full-width state (16 MB) is read by the port in
    under 2 s (printed).

(d), a resume after JAX steps, is tests/test_torch_orbax_resume.py; the
two CLIs on the fixture, tests/test_torch_orbax_cli.py.
"""

import io
import json
import shutil
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from retinex_tpu.models.retinex_net import MultiScaleUPRetinex as JNet
from retinex_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from retinex_tpu.train.checkpoint import load_params_for_inference as jax_load_params
from retinex_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retinex_tpu.train.train_state import create_train_state as jax_create_train_state
from retinex_tpu_torch import cli
from retinex_tpu_torch.config import Config
from retinex_tpu_torch.models.convert import adam_state_to_optax, state_dict_to_variables
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.train import orbax as port_orbax
from retinex_tpu_torch.train.checkpoint import load_checkpoint, load_params_for_inference
from retinex_tpu_torch.train.orbax import OrbaxFormatError, crc32c, read_orbax, read_zarr, zstd_decompress
from retinex_tpu_torch.train.train_state import create_train_state

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the fixture's numpy regeneration, shared with the card's phase 25)

FIXTURE = chip_smoke.ORBAX_FIXTURE


# ---- (a) the zstd decoder --------------------------------------------------------


def _data(name: str) -> bytes:
    rng = np.random.default_rng(7)
    if name == "empty":
        return b""
    if name == "one_byte":
        return b"x"
    if name == "random_1mb":
        return rng.bytes(1 << 20)
    if name == "zeros":
        return bytes(1 << 20)
    if name == "text":
        return b"".join(b"line %d of a low-light photo's log, the same words again\n" % (i % 113) for i in range(9000))
    return (rng.standard_normal(262144) * 0.05).astype(np.float32).tobytes()  # a conv kernel's worth of f32


DATA = ["empty", "one_byte", "random_1mb", "zeros", "text", "weights"]


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", DATA)
def test_zstd_decodes_what_zstandard_encodes(name, level):
    data = _data(name)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd_decompress(frame) == data


def test_zstd_frames_without_content_size_with_checksums_and_several():
    text, weights = _data("text"), _data("weights")
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(buf, closefd=False) as w:
        for i in range(0, len(weights), 70000):
            w.write(weights[i:i + 70000])
    assert zstd_decompress(buf.getvalue()) == weights  # streamed: no content size in the header
    unsized = zstandard.ZstdCompressor(level=1, write_content_size=False).compress(text)
    assert zstd_decompress(unsized) == text
    summed = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(text)
    assert zstd_decompress(summed) == text
    two = zstandard.compress(text, 3) + zstandard.compress(weights, 1)
    assert zstd_decompress(two) == text + weights
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"abcde"
    assert zstd_decompress(skip + zstandard.compress(b"hello") + skip) == b"hello"


def test_zstd_content_over_the_block_maximum():
    rng = np.random.default_rng(3)
    incompressible = rng.bytes(300_000)  # raw blocks of 128 KB
    mixed = incompressible + bytes(200_000) + _data("text")[:300_000]
    for data in (incompressible, mixed):
        frame = zstandard.ZstdCompressor(level=1).compress(data)
        assert zstd_decompress(frame) == data
    # A raw block that claims more than 128 KB raises.
    header = bytes([0x28, 0xB5, 0x2F, 0xFD, 0x00, 0x58])  # no content size, window 1 MB
    size = 128 * 1024 + 1
    block = ((size << 3) | 1).to_bytes(3, "little") + bytes(size)
    with pytest.raises(ValueError, match="block maximum"):
        zstd_decompress(header + block)


def test_zstd_truncated_or_corrupt_input_raises():
    small = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(_data("text")[:4000])
    for cut in range(len(small)):
        with pytest.raises(ValueError):
            zstd_decompress(small[:cut])
    big = zstandard.ZstdCompressor(level=3).compress(_data("weights"))
    for cut in range(0, len(big), len(big) // 40):
        with pytest.raises(ValueError):
            zstd_decompress(big[:cut])
    data = _data("text")[:200_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    rng = np.random.default_rng(11)
    raised = 0
    for _ in range(200):
        bad = bytearray(frame)
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = zstd_decompress(bytes(bad))
        except ValueError:
            raised += 1
            continue
        assert out == data  # a bit the decoder does not read (the window size), never wrong bytes
    assert raised >= 190
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd_decompress(b"\x00" * 16)


def test_zstd_dictionary_raises():
    samples = [b"sample %d of a dictionary's training text, the same words again" % i for i in range(2000)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[5])
    with pytest.raises(ValueError, match="dictionar"):
        zstd_decompress(frame)


def test_crc32c():
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert crc32c(b"") == 0


# ---- (b) read_orbax against orbax -----------------------------------------------


def same_as_orbax(got, want, path="") -> int:
    """Bit for bit (bfloat16 as its f32 widening); returns the count of
    leaves, an empty container or None counted as one, as _METADATA does."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        return sum(same_as_orbax(got[k], want[k], f"{path}/{k}") for k in want) if want else 1  # {}: one entry
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, got, want)
        return sum(same_as_orbax(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want)))
    if want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
        return 1
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        assert got.dtype == np.float32 and got.shape == want.shape, path
        assert np.array_equal(got.view(np.uint32), want.view(np.uint16).astype(np.uint32) << 16), path
        return 1
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == np.ascontiguousarray(want).tobytes(), path
    return 1


def _leaf_entries(path) -> dict:
    """The leaves _METADATA lists (empty containers and None among them)."""
    return json.loads((Path(path) / "_METADATA").read_text())["tree_metadata"]


def _dtypes_tree():
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((64, 3)), jnp.float32), NamedSharding(mesh, PartitionSpec("data")))
    return {
        "f32": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)},
        "bf16": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4), "i64": np.asarray(2**40 + 3, np.int64),
        "f64": np.asarray(-1.25e-300, np.float64), "u32": np.array([928981903, 3453687069], np.uint32),
        "jax_scalar": jnp.int32(7), "py_int": 5, "py_float": 0.5,
        "big": rng.standard_normal(300_000).astype(np.float32),
        "sharded": sharded,
        "seq": [np.ones(2, np.float32), {"a": np.zeros(3, np.int32)}], "tup": (jnp.float32(2.0),),
        "none": None, "empty_dict": {},
    }


def _many_leaves_tree():
    rng = np.random.default_rng(1)
    return {f"block{i:03d}": {"kernel": rng.standard_normal((i % 5 + 1, 3)).astype(np.float32),
                              "bias": np.full(i % 7 + 1, i, np.float32)} for i in range(150)}


def repack(src: Path, dst: Path, node_bytes: int = 4096) -> None:
    """The same checkpoint with its OCDBT store rewritten by tensorstore
    with small B-tree nodes (interior nodes), metadata files copied."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("manifest.ocdbt", "d", "ocdbt.process_*"))
    old = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{src}/"}).result()
    new = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{dst}/", "config": {
        "max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": 1024, "compression": {"id": "zstd"}}}).result()
    txn = ts.Transaction()
    for key in old.list().result():
        new.with_transaction(txn)[key] = old.read(key).result().value
    txn.commit_async().result()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{name: (directory, the tree orbax restores from it)}."""
    root = tmp_path_factory.mktemp("orbax_trees")
    ckptr = ocp.StandardCheckpointer()
    out = {}
    for name, tree in (("dtypes", _dtypes_tree()), ("many_leaves", _many_leaves_tree())):
        ckptr.save(root / name, tree)
        ckptr.wait_until_finished()
        out[name] = (root / name, ckptr.restore(root / name))
    repack(root / "many_leaves", root / "many_leaves_4k")
    repack(root / "dtypes", root / "dtypes_4k", node_bytes=1024)
    out["many_leaves_4k"] = (root / "many_leaves_4k", out["many_leaves"][1])
    out["dtypes_4k"] = (root / "dtypes_4k", out["dtypes"][1])
    return out


@pytest.mark.parametrize("name", ["dtypes", "many_leaves", "many_leaves_4k", "dtypes_4k"])
def test_read_orbax_equals_orbax_restore(written, name):
    path, want = written[name]
    assert same_as_orbax(read_orbax(str(path)), want) == len(_leaf_entries(path))


def test_the_trees_take_every_path_of_the_format(written):
    store = port_orbax.read_ocdbt(str(written["dtypes"][0]))
    assert [k for k in store if k.startswith("sharded/") and k != "sharded/.zarray"] == [f"sharded/{i}.0" for i in range(8)]
    assert isinstance(store["big/0"], tuple)  # 1.2 MB: in a data file, not inline
    assert isinstance(store["i32/0.0"], bytes)
    assert port_orbax._manifest_root(str(written["dtypes"][0]))[4] == 0
    for name in ("many_leaves_4k", "dtypes_4k"):
        assert port_orbax._manifest_root(str(written[name][0]))[4] >= 1, f"{name} has no interior node"
    sel = read_orbax(str(written["dtypes"][0]), select=("u32", "f64"))
    assert sel.keys() == {"u32", "f64"} and sel["u32"].tolist() == [928981903, 3453687069]


def test_what_orbax_does_not_write_here_raises(written, tmp_path):
    with pytest.raises(OrbaxFormatError, match="not an Orbax checkpoint"):
        read_orbax(str(tmp_path))
    with pytest.raises(OrbaxFormatError, match="not a directory"):
        read_orbax(str(tmp_path / "missing"))
    agg = tmp_path / "aggregated"
    shutil.copytree(written["dtypes"][0], agg)
    (agg / "checkpoint").write_bytes(b"\x80")
    with pytest.raises(OrbaxFormatError, match="msgpack"):
        read_orbax(str(agg))
    z3 = tmp_path / "zarr3"
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)) as ck:
        ck.save(z3, {"a": np.ones(3, np.float32)})
    with pytest.raises(OrbaxFormatError, match="zarr"):
        read_orbax(str(z3))
    meta = b'{"zarr_format": 2, "compressor": {"id": "blosc"}, "dtype": "<f4", "shape": [2], "chunks": [2]}'
    with pytest.raises(OrbaxFormatError, match="blosc"):
        read_zarr({"x/.zarray": meta}, "x")
    bad = tmp_path / "bad_crc"
    shutil.copytree(written["dtypes"][0], bad)
    raw = bytearray((bad / "manifest.ocdbt").read_bytes())
    raw[20] ^= 1
    (bad / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(OrbaxFormatError, match="CRC"):
        read_orbax(str(bad))


# ---- (c) the committed fixture and the JAX package's own checkpoints -------------


@pytest.fixture(scope="module")
def jax_state():
    """create_train_state at the CLI defaults (see the module docstring)."""
    return jax_create_train_state(JNet(use_preact=False, use_aspp=False), jax.random.PRNGKey(0), (1, 64, 64, 3),
                                  lambda step: 1e-4, weight_decay=1e-5, grad_accum=1)


def _with_kernels(tree, want):
    return {k: _with_kernels(v, want[k]) if isinstance(v, dict) else (want[k] if k == "kernel" else v)
            for k, v in tree.items()}


def write_orbax_fixture(jax_state, save_dir) -> Path:
    """The fixture: the JAX state with every params kernel replaced by
    chip_smoke.orbax_fixture_tree()'s, saved by the JAX package's
    save_checkpoint at its epoch and best loss; returns ``<save_dir>/latest``.
    Run into tests/fixtures/orbax_jax to rewrite the committed copy."""
    params = _with_kernels(jax_state.params, chip_smoke.orbax_fixture_tree()["params"])
    jax_save_checkpoint(jax_state.replace(params=params), str(save_dir), chip_smoke.ORBAX_FIXTURE_EPOCH,
                        chip_smoke.ORBAX_FIXTURE_BEST_LOSS, is_best=False)
    return Path(save_dir) / "latest"


def test_fixture_is_the_numpy_regeneration():
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 2_000_000, f"the fixture takes {size} bytes"
    got = read_orbax(str(FIXTURE))
    assert chip_smoke.same_tree(got, chip_smoke.orbax_fixture_tree()) == len(_leaf_entries(FIXTURE))
    assert same_as_orbax(got, ocp.StandardCheckpointer().restore(FIXTURE)) == len(_leaf_entries(FIXTURE))


def test_regeneration_is_the_jax_init_but_for_its_kernels(jax_state):
    """Every leaf but the params kernels is the JAX init's, bit for bit; the
    kernels have its shapes."""
    from retinex_tpu.train.checkpoint import _state_to_pytree

    jax_tree = jax.tree_util.tree_map(np.asarray, _state_to_pytree(
        jax_state, chip_smoke.ORBAX_FIXTURE_EPOCH, chip_smoke.ORBAX_FIXTURE_BEST_LOSS))
    want = chip_smoke.orbax_fixture_tree()
    kernels = {p: v for p, v in chip_smoke._tree_leaves(want["params"]).items() if p[-1] == "kernel"}
    jax_params = chip_smoke._tree_leaves(jax_tree["params"])
    assert all(jax_params[p].shape == v.shape and jax_params[p].dtype == v.dtype for p, v in kernels.items())
    for tree in (jax_tree, want):
        tree["params"] = _with_kernels(tree["params"], want["params"])
    opt = jax_tree["opt_state"]
    jax_tree["opt_state"] = [None, None, {"count": opt[2].count, "mu": opt[2].mu, "nu": opt[2].nu},
                             {"count": opt[3].count}]
    jax_tree["step"] = int(jax_tree["step"])
    assert chip_smoke.same_tree(jax_tree, want) > 400


def test_writer_reproduces_the_committed_fixture(jax_state, tmp_path):
    path = write_orbax_fixture(jax_state, tmp_path)
    ckptr = ocp.StandardCheckpointer()
    assert same_as_orbax(read_orbax(str(path)), ckptr.restore(FIXTURE)) > 400


def test_port_loaders_equal_the_jax_package_on_the_fixture(jax_state):
    want = jax_load_params(str(FIXTURE))
    got = load_params_for_inference(str(FIXTURE))
    assert same_as_orbax(got, {"params": want["params"], "batch_stats": want["batch_stats"]}) == 145 + 38
    jstate, jepoch, jbest = jax_load_checkpoint(jax_state, str(FIXTURE))
    state = create_train_state(MultiScaleUPRetinex(False, False), lambda s: 1e-4)
    state, epoch, best, extra = load_checkpoint(state, str(FIXTURE))
    assert (epoch, best, extra, state.step) == (jepoch, jbest, {}, int(jstate.step))
    variables = state_dict_to_variables(state.model.state_dict(), use_aspp=False)
    assert same_as_orbax(variables, {"params": jstate.params, "batch_stats": jstate.batch_stats}) == 145 + 38
    adam = jstate.opt_state[2]
    mu, nu, count = adam_state_to_optax({"mu": state.optimizer.mu, "nu": state.optimizer.nu,
                                         "count": state.optimizer.count}, use_aspp=False)
    assert count == int(adam.count) and same_as_orbax(mu, adam.mu) == same_as_orbax(nu, adam.nu) == 145
    for got_t, want_t in ((state.loss_state.prev, jstate.loss_state.prev), (state.loss_state.prev2, jstate.loss_state.prev2),
                          (state.loss_state.step, jstate.loss_state.step)):
        assert same_as_orbax(got_t.numpy(), want_t) == 1


def test_cli_builds_the_net_from_the_fixture_and_refuses_other_nets(tmp_path):
    model = cli.build_model(Config(checkpoint=str(FIXTURE)), torch.device("cpu"))
    want = chip_smoke.orbax_fixture_tree()
    got = state_dict_to_variables(model.state_dict(), use_aspp=False)
    assert chip_smoke.same_tree(got, {"params": want["params"], "batch_stats": want["batch_stats"]}) == 145 + 38
    with pytest.raises(ValueError, match=r"use_preact=True.*shapes .*ie_net\.enc1\.bn1"):
        cli.build_model(Config(checkpoint=str(FIXTURE), use_preact=True), torch.device("cpu"))
    with pytest.raises(ValueError, match=r"use_aspp=True.*missing \d+ leaves .*aspp"):
        cli.build_model(Config(checkpoint=str(FIXTURE), use_aspp=True), torch.device("cpu"))
    with pytest.raises(OrbaxFormatError, match="not an Orbax checkpoint"):
        cli.build_model(Config(checkpoint=str(tmp_path)), torch.device("cpu"))


def test_a_fresh_full_width_checkpoint_reads_in_under_two_seconds(jax_state, tmp_path):
    """The JAX init's 4,275,475 random parameters (16 MB on disk)."""
    jax_save_checkpoint(jax_state, str(tmp_path), 0, float("inf"), is_best=False)
    path = str(tmp_path / "latest")
    size = sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())
    load_params_for_inference(path)  # the decoder's build, once per checkout
    t0 = time.perf_counter()
    got = load_params_for_inference(path)
    seconds = time.perf_counter() - t0
    print(f"load_params_for_inference of a fresh {size / 1e6:.1f} MB JAX checkpoint: {seconds:.3f} s on the CPU")
    assert size > 15e6 and seconds < 2.0
    want = jax_load_params(path)
    assert same_as_orbax(got, {"params": want["params"], "batch_stats": want["batch_stats"]}) == 145 + 38
