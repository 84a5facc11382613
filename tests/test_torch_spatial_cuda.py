"""Spatial sharding's kernels on the card: K3 (its three cell-mode
instances, K8's apply half among them) and K7 on row slabs at their
cell-row offset ``row0``, against their plain versions with the same
``row0`` and against the whole frame's launch; ``make_spatial_clahe`` and
``make_spatial_forward`` on meshes that repeat ``cuda:0``, against one
card.

Marked ``cuda``: the kernels have no CPU mode, so without a card these
tests skip (decided in a fixture). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only the port's
dependencies, without the repository's conftest::

    python -m pytest tests/test_torch_spatial_cuda.py -m cuda --noconftest
"""

import pytest
import torch

from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_luma as cl

MESHES = (2, 4, 8)


def _within_one_level(got, want):
    """K3 against its plain version, as tests/test_torch_cuda.py holds it:
    1 level on under 1e-4 of the bytes (the plain sRGB pow on the card)."""
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _frame(card, b: int, h: int, w: int, seed: int):
    g = torch.Generator(device=card).manual_seed(seed)
    rgb = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=card, generator=g)
    lab = cg.lab_fwd_u8_nhwc_plain(rgb)
    y = cl._luma_u8(rgb, dim=3)
    return rgb, lab, y, cg.clahe_tables_plain(lab), cg.clahe_tables_plain(y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", MESHES)
def test_k3_and_k7_on_slabs_match_their_plain_versions(card, n):
    """Each slab's K3 (three instances) within one level of its plain
    version at the same row0 and K7 exact, each equal to the whole frame's
    launch on those rows."""
    rgb, lab, y, luts, luts_y = _frame(card, 2, 272, 480, n)
    whole = {
        "u8": cg.clahe_apply_u8(lab, luts), "f32": cg.clahe_apply_f32_nhwc(lab, luts),
        "nhwc": cg.clahe_apply_u8_nhwc(lab, luts), "k7": cl.clahe_luma_apply_u8(rgb, y, luts_y),
        "k7p": cl.clahe_luma_apply_u8(rgb.permute(0, 3, 1, 2).contiguous(), y, luts_y),
    }
    ncy, rows = 16 // n, 272 // n
    cg.reset_launches()
    cl.reset_launches()
    for i in range(n):
        r, row0 = slice(i * rows, (i + 1) * rows), i * ncy
        ls = lab[:, :, r].contiguous()
        got = cg.clahe_apply_u8(ls, luts, row0, ncy)
        _within_one_level(got, cg.clahe_apply_u8_plain(ls, luts, row0, ncy))
        assert torch.equal(got, whole["u8"][:, :, r])
        got = cg.clahe_apply_f32_nhwc(ls, luts, row0, ncy)
        _within_one_level(torch.round(got * 255.0), torch.round(cg.clahe_apply_f32_nhwc_plain(ls, luts, row0, ncy) * 255.0))
        assert torch.equal(got, whole["f32"][:, r])
        got = cg.clahe_apply_u8_nhwc(ls, luts, row0, ncy)
        _within_one_level(got, cg.clahe_apply_u8_nhwc_plain(ls, luts, row0, ncy))
        assert torch.equal(got, whole["nhwc"][:, r])
        xs, ys = rgb[:, r].contiguous(), y[:, r].contiguous()
        got = cl.clahe_luma_apply_u8(xs, ys, luts_y, row0, ncy)
        assert torch.equal(got, cl.clahe_luma_apply_u8_plain(xs, ys, luts_y, row0, ncy)) and torch.equal(got, whole["k7"][:, r])
        xp = xs.permute(0, 3, 1, 2).contiguous()
        assert torch.equal(cl.clahe_luma_apply_u8(xp, ys, luts_y, row0, ncy), whole["k7p"][:, :, r])
    torch.cuda.synchronize()
    assert cg.LAUNCHES["clahe_apply_u8"] == cg.LAUNCHES["clahe_apply_f32_nhwc"] == cg.LAUNCHES["clahe_apply_u8_nhwc"] == n
    assert cl.LAUNCHES["clahe_luma_apply_u8"] == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("mode", ["clahe", "clahe_luma"])
def test_spatial_clahe_on_a_mesh_of_one_card(card, n, mode):
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb
    from retinex_tpu_torch.ops.clahe_luma import clahe_luma_rgb
    from retinex_tpu_torch.parallel.mesh import Mesh
    from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_clahe, shard_rows

    g = torch.Generator(device=card).manual_seed(n)
    x = torch.rand((1, 544, 960, 3), device=card, generator=g) * 0.45
    mesh = Mesh((card,) * n)
    got = gather_rows(make_spatial_clahe(mesh, mode, hist_subsample=2 if n == 4 else 1)(shard_rows(x, mesh)), card)
    one = (clahe_lab_rgb if mode == "clahe" else clahe_luma_rgb)(x, hist_subsample=2 if n == 4 else 1)
    assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(False, False), (True, True)])
def test_spatial_forward_on_a_mesh_of_one_card(card, flags):
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
    from retinex_tpu_torch.parallel.mesh import Mesh
    from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_forward, shard_rows

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_untrained(MultiScaleUPRetinex(*flags), 3).eval().to(card)
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.rand((1, 128, 256, 3), device=card, generator=g) * 0.85 + 0.05
    with torch.inference_mode():
        one = model(x)
    for n in MESHES:
        mesh = Mesh((card,) * n)
        out = make_spatial_forward(model, mesh)(shard_rows(x, mesh))
        for a, b in zip(out, one):
            a = gather_rows(a, card)
            assert torch.isfinite(a).all()
            assert float((a - b).abs().max()) <= 2e-6
