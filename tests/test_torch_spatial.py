"""The port's spatial sharding (``retinex_tpu_torch/parallel/spatial.py``)
against the JAX package's (``retinex_tpu/parallel/spatial.py``) and against
the port's own one-device routes, on the CPU.

- ``make_spatial_clahe`` on n logical CPU shards, both modes, at 64x64 for
  n = 1, 2, 4, 8 (and ``hist_subsample=2`` at n = 4): byte-identical to the
  JAX package's on its forced 8-CPU-device mesh, and equal to the port's
  one-device route; the JAX package's shape errors, and
  ``enhance_single_image``'s printed one-device route where they would hit.
- ``make_spatial_forward`` on the JAX test's (1, 64, 128, 3) at n = 2, 4, 8
  for the CLI's net and pre-activation + ASPP, the weights carried across
  by the JAX package's converter: against JAX's spatial forward at the
  port's standard-net parity tolerances (tests/test_torch_model.py), and
  against the port's one-device forward within 2e-6 (the means' summation
  order); no NaN; H % 8n raises. At n = 8 the scale-3 tower's H/16 stage
  has 4 rows over 8 slabs, and ASPP's dilation 18 at the /8 stage (8 rows)
  reaches past every neighbour. The bf16 net within the bf16 bounds of one
  device.
- The plain applies with ``row0`` (``clahe_fast.apply_from_cells``, K3's
  and K7's plain versions) against JAX's ``_apply_from_cells(...,
  row0=...)`` compiled (as its sharded CLAHE runs it) and against the whole
  frame's rows.

The JAX programs are compiled once, in one module fixture. The kernels
against their plain versions with ``row0`` are in
tests/test_torch_spatial_cuda.py (they need the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu.ops.clahe_fast import _apply_from_cells as jax_apply_from_cells
from retinex_tpu.parallel.mesh import create_mesh as jax_create_mesh
from retinex_tpu.parallel.mesh import replicate as jax_replicate
from retinex_tpu.parallel.spatial import make_spatial_clahe as jax_spatial_clahe
from retinex_tpu.parallel.spatial import make_spatial_forward as jax_spatial_forward
from retinex_tpu.parallel.spatial import spatial_sharding
from retinex_tpu_torch.infer.enhance import enhance_single_image
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_luma as cl
from retinex_tpu_torch.ops.clahe import clahe_lab_rgb
from retinex_tpu_torch.ops.clahe_fast import apply_from_cells
from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb
from retinex_tpu_torch.parallel.mesh import create_mesh
from retinex_tpu_torch.parallel.spatial import (
    Rows,
    _Net,
    gather_rows,
    make_spatial_clahe,
    make_spatial_forward,
    shard_rows,
    split_rows,
)

CLAHE_CASES = [(mode, n, 1) for mode in ("clahe", "clahe_luma") for n in (1, 2, 4, 8)]
CLAHE_CASES += [(mode, 4, 2) for mode in ("clahe", "clahe_luma")]
NETS = {"cli": (False, False), "preact_aspp": (True, True)}
NET_MESHES = (2, 4, 8)
# tests/test_torch_model.py's bounds for the port's standard net against JAX's.
JAX_NET_ATOL = {"enhanced": 2e-3, "reflectance": 2e-3, "illumination": 2e-5}
# The spatial forward against one device: the means' summation order only.
ONE_DEVICE_ATOL = 2e-6
# bf16: the means' rounding to bf16 flips now and then, and the flips add up
# (as chip_smoke.py's AMP_NET_TOL for two bf16 formulations of the net).
BF16_ATOL = {"enhanced": 2e-2, "reflectance": 3e-2, "illumination": 2.0**-7}
OUTPUTS = ("enhanced", "reflectance", "illumination")


def _photo(shape, seed: int) -> np.ndarray:
    """A dark seeded frame, where CLAHE moves pixels."""
    return np.random.default_rng(seed).uniform(0.0, 0.45, shape).astype(np.float32)


def _net(flags, seed: int = 3, dtype=torch.float32) -> MultiScaleUPRetinex:
    """The CLI's untrained draw with seeded BatchNorm statistics."""
    port = init_untrained(MultiScaleUPRetinex(*flags, dtype=dtype), seed).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(buf.shape)).astype(np.float32)))
    return port


def _jax_bytes(x) -> np.ndarray:
    return np.asarray(jnp.round(jnp.asarray(x) * 255.0)).astype(np.int32)


def _port_bytes(x: torch.Tensor) -> np.ndarray:
    return torch.round(x * 255.0).to(torch.int32).numpy()


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX sharded program of this file, compiled and run once:
    {("clahe", mode, n, s): output, ("net", config, n): outputs, "x": the
    net's input, "nets": {config: port module}}."""
    runs = {}
    frame = _photo((1, 64, 64, 3), 0)
    for mode, n, s in CLAHE_CASES:
        mesh = jax_create_mesh(n)
        fn = jax_spatial_clahe(mesh, mode=mode, hist_subsample=s)
        runs[("clahe", mode, n, s)] = np.asarray(fn(jax.device_put(jnp.asarray(frame), spatial_sharding(mesh))))
    x = np.random.default_rng(1).uniform(0.05, 0.9, (1, 64, 128, 3)).astype(np.float32)
    runs["x"], runs["frame"], runs["nets"] = x, frame, {}
    for name, flags in NETS.items():
        port = _net(flags)
        runs["nets"][name] = port
        model = JaxNet(use_preact=flags[0], use_aspp=flags[1])
        variables = torch_state_dict_to_variables(port.state_dict(), *flags)
        for n in NET_MESHES:
            mesh = jax_create_mesh(n)
            out = jax_spatial_forward(model, mesh)(
                jax.device_put(variables, jax_replicate(mesh)), jax.device_put(jnp.asarray(x), spatial_sharding(mesh))
            )
            runs[("net", name, n)] = [np.asarray(o) for o in out]
    return runs


@pytest.mark.parametrize("mode,n,s", CLAHE_CASES)
def test_spatial_clahe_matches_jax_and_one_device(jax_runs, mode, n, s):
    frame = torch.from_numpy(jax_runs["frame"])
    mesh = create_mesh(n, "cpu")
    slabs = make_spatial_clahe(mesh, mode=mode, hist_subsample=s)(shard_rows(frame, mesh))
    assert [t.shape[1] for t in slabs] == [64 // n] * n
    got = gather_rows(slabs, "cpu")
    np.testing.assert_array_equal(_port_bytes(got), _jax_bytes(jax_runs[("clahe", mode, n, s)]))
    one = (clahe_lab_rgb if mode == "clahe" else clahe_luma_rgb)(frame, hist_subsample=s)
    assert torch.equal(got, one)


def test_spatial_clahe_rejects_bad_shapes():
    with pytest.raises(ValueError, match="H % 16"):
        mesh = create_mesh(2, "cpu")
        make_spatial_clahe(mesh)(shard_rows(torch.zeros((1, 60, 64, 3)), mesh))
    with pytest.raises(ValueError, match="must divide"):
        make_spatial_clahe(create_mesh(3, "cpu"))
    with pytest.raises(ValueError, match="unknown spatial CLAHE mode"):
        make_spatial_clahe(create_mesh(2, "cpu"), mode="msr")


@pytest.mark.parametrize("n,tiles", [(3, 8), (2, 6)])
def test_enhance_single_image_prints_the_one_device_route(tmp_path, capsys, n, tiles):
    """A mesh that does not divide the tiles, or a frame that is not
    cell-divisible (64 rows at 6 tiles): the JAX package's line, then the
    one-device route's bytes."""
    from PIL import Image

    path = tmp_path / "frame.png"
    Image.fromarray((_photo((64, 64, 3), 5) * 255).astype(np.uint8)).save(path)
    knobs = dict(classical_mode="clahe", tiles=tiles, device="cpu", save_outputs=False)
    got, _, _ = enhance_single_image(None, str(path), str(tmp_path), mesh=create_mesh(n, "cpu"), **knobs)
    assert "falling back to single-device" in capsys.readouterr().out
    want, _, _ = enhance_single_image(None, str(path), str(tmp_path), **knobs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", NET_MESHES)
@pytest.mark.parametrize("config", list(NETS))
def test_spatial_forward_matches_jax_and_one_device(jax_runs, config, n):
    port = jax_runs["nets"][config]
    x = torch.from_numpy(jax_runs["x"])
    mesh = create_mesh(n, "cpu")
    out = make_spatial_forward(port, mesh)(shard_rows(x, mesh))
    for slabs in out:
        assert [t.shape[1] for t in slabs] == [64 // n] * n  # left sharded, as JAX's
    got = [gather_rows(o, "cpu").numpy() for o in out]
    with torch.inference_mode():
        one = [o.numpy() for o in port(x)]
    for name, g, o, j in zip(OUTPUTS, got, one, jax_runs[("net", config, n)]):
        assert not np.isnan(g).any(), name
        np.testing.assert_allclose(g, o, rtol=0, atol=ONE_DEVICE_ATOL, err_msg=name)
        np.testing.assert_allclose(g, j, rtol=0, atol=JAX_NET_ATOL[name], err_msg=name)


def test_spatial_forward_bf16_within_bf16_bounds(jax_runs):
    port = _net(NETS["preact_aspp"], dtype=torch.bfloat16)
    x = torch.from_numpy(jax_runs["x"])
    mesh = create_mesh(8, "cpu")
    got = [gather_rows(o, "cpu") for o in make_spatial_forward(port, mesh)(shard_rows(x, mesh))]
    with torch.inference_mode():
        one = port(x)
    for name, g, o in zip(OUTPUTS, got, one):
        assert g.dtype == o.dtype and torch.isfinite(g.float()).all(), name
        np.testing.assert_allclose(g.float().numpy(), o.float().numpy(), rtol=0, atol=BF16_ATOL[name], err_msg=name)


def test_spatial_forward_rejects_misaligned_height(jax_runs):
    port = jax_runs["nets"]["cli"]
    mesh = create_mesh(8, "cpu")
    fwd = make_spatial_forward(port, mesh)
    with pytest.raises(ValueError, match="divisible"):
        fwd(shard_rows(torch.zeros((1, 40, 128, 3)), mesh))


def test_spatial_net_has_no_default_row_rule():
    """A module the slabs have no rule for raises, and a pointwise step on
    stages split differently raises, rather than running slab by slab."""
    cpu = torch.device("cpu")
    net = _Net([], (cpu, cpu))
    t = Rows([torch.zeros((1, 2, 3, 4)), torch.zeros((1, 2, 3, 4))], [0, 3, 6])
    pool = torch.nn.AvgPool2d(3, 1, 1)
    with pytest.raises(TypeError, match="AvgPool2d"):
        net.module(lambda _net: pool, pool, t)
    uneven = Rows([torch.zeros((1, 2, 2, 4)), torch.zeros((1, 2, 4, 4))], [0, 2, 6])
    with pytest.raises(ValueError, match="split their rows differently"):
        net.map(lambda i, a, b: a + b, t, uneven)
    assert [p.shape[2] for p in net.map(lambda i, p: p + 1, uneven).parts] == [2, 4]


def test_split_rows_covers_every_row_once():
    for n_rows in (0, 1, 4, 8, 68, 1088):
        for n in (1, 2, 3, 8):
            b = split_rows(n_rows, n)
            assert b[0] == 0 and b[-1] == n_rows and all(0 <= q - p <= -(-n_rows // n) for p, q in zip(b, b[1:]))


@pytest.mark.parametrize("n,tiles", [(2, 8), (4, 8), (8, 8), (2, 4)])
def test_plain_applies_with_row0(n, tiles):
    """Each slab's apply at its row0 against JAX's _apply_from_cells on that
    slab's cell view, and against the whole frame's apply (rows of it):
    the L-plane blend, K3's plain version (planar u8 and float NHWC) and
    K7's (planar and NHWC)."""
    rng = np.random.default_rng(n)
    b, h, w = 2, 4 * tiles * 4, 2 * tiles * 3
    plane = torch.from_numpy(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
    luts = torch.from_numpy(np.sort(rng.integers(0, 256, (b, tiles, tiles, 256)), axis=-1).astype(np.uint8))
    lab = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8))
    rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    y = cl._luma_u8(rgb, dim=3)
    whole = apply_from_cells(plane, luts)
    k3 = cg.clahe_apply_u8_plain(lab, luts)
    k3f = cg.clahe_apply_f32_nhwc_plain(lab, luts)
    k7 = cl.clahe_luma_apply_u8_plain(rgb, y, luts)
    k7p = cl.clahe_luma_apply_u8_plain(rgb.permute(0, 3, 1, 2), y, luts)
    ncy_loc, rows = 2 * tiles // n, h // n
    hh, hw = h // (2 * tiles), w // (2 * tiles)
    # Compiled, with row0 traced, as the JAX package's sharded CLAHE runs it
    # (the port's blend rounds as the compiled CPU program contracts it).
    jax_apply = jax.jit(lambda v5, lut, row0: jax_apply_from_cells(v5, lut, tiles, tiles, row0=row0))
    for i in range(n):
        r = slice(i * rows, (i + 1) * rows)
        row0 = i * ncy_loc
        got = apply_from_cells(plane[:, r], luts, row0, ncy_loc)
        v5 = jnp.asarray(plane[:, r].numpy().astype(np.int32)).reshape(b, ncy_loc, hh, 2 * tiles, hw)
        want = np.asarray(jax_apply(v5, jnp.asarray(luts.numpy().astype(np.int32)), row0))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, whole[:, r])
        assert torch.equal(cg.clahe_apply_u8_plain(lab[:, :, r].contiguous(), luts, row0, ncy_loc), k3[:, :, r])
        assert torch.equal(cg.clahe_apply_f32_nhwc(lab[:, :, r].contiguous(), luts, row0, ncy_loc), k3f[:, r])
        assert torch.equal(cg.clahe_apply_u8_nhwc(lab[:, :, r].contiguous(), luts, row0, ncy_loc), k3[:, :, r].permute(0, 2, 3, 1))
        ys = y[:, r].contiguous()
        assert torch.equal(cl.clahe_luma_apply_u8(rgb[:, r].contiguous(), ys, luts, row0, ncy_loc), k7[:, r])
        planar = rgb[:, r].permute(0, 3, 1, 2).contiguous()
        assert torch.equal(cl.clahe_luma_apply_u8(planar, ys, luts, row0, ncy_loc), k7p[:, :, r])


def test_apply_rejects_a_slab_outside_the_frame():
    lab = torch.zeros((1, 3, 32, 16), dtype=torch.uint8)
    luts = torch.zeros((1, 8, 8, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cell rows"):
        cg.clahe_apply_u8(lab, luts, 15, 2)
    with pytest.raises(ValueError, match="cell rows"):
        cg.clahe_apply_u8(lab, luts, 0, 3)
