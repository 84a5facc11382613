"""K6's weight packing and K2's launch plan, on the CPU.

- ``pack_tail_g1`` tells a quadrant-block-diagonal w (the packed model's
  fusion folds) from a dense one, once per model, and lays each out for the
  kernel's instance; ``fam_tail_apply_g1`` refuses a ``packed=`` made from
  another w or of a layout its instance does not read, and lays an
  unpacked w out for the dense instance without inspecting it. The plain
  K6 at a ``pack_pointwise`` w is held to the JAX package's Pallas kernel
  in interpret mode at K6's 1e-4 (tests/test_fused_blocks.py), on inputs
  made from a numpy seed.
- ``tables_plan`` and ``strip_rows`` (K2's row strips) read every sampled
  row of a tile exactly once, and ``_load_width`` picks the widest load the
  plane allows.

The kernels themselves are held to their plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import fused_blocks as tfb
from retinex_tpu_torch.ops.s2d import pack_pointwise


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _diag_w(seed: int) -> torch.Tensor:
    """pack_pointwise of a seeded [1,1,32,32] 1x1: the main path's K6 weight form."""
    k = np.random.default_rng(seed).standard_normal((1, 1, 32, 32)) * 0.1
    return _t(pack_pointwise(k)[0, 0])


def _tail_inputs(rng, b, h, w):
    """K6 inputs scaled as tests/test_fused_blocks.py's tail tests."""
    x = (np.abs(rng.standard_normal((b, h, w, 128))) * 0.4).astype(np.float32)
    ca = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, 32))))
    sa = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, w, 4))))).astype(np.float32)
    return x, np.tile(ca, 4).astype(np.float32), sa


@pytest.fixture(scope="module")
def packed_model():
    from retinex_tpu_torch.cli import init_untrained
    from retinex_tpu_torch.models.packed_inference import PackedRetinex
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    return PackedRetinex(init_untrained(MultiScaleUPRetinex(False, False), seed=0).eval())


def test_pack_tail_g1_marks_the_models_folds_quadrant_diagonal(packed_model):
    """Both fusion folds of a full-width PackedRetinex are [128, 128] and
    block-diagonal, so the kernel's diagonal instance serves the main path;
    its layout holds the four diagonal blocks."""
    for fold in (packed_model.fold_f1, packed_model.fold_f2):
        assert isinstance(fold, tfb.TailG1Packed) and fold.diag
        assert fold.w.shape == (128, 128) and fold.kernel_w.shape == (128, 32)
        for q in range(4):
            assert torch.equal(fold.kernel_w[32 * q : 32 * q + 32], fold.w[32 * q : 32 * q + 32, 32 * q : 32 * q + 32])


@pytest.mark.parametrize("entry", [None, (5, 100), (127, 0)])
def test_pack_tail_g1_marks_other_weights_dense(entry):
    """A dense random w, and a block-diagonal w with one entry set outside
    its blocks, are dense: the kernel's layout is w itself."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((128, 128)).astype(np.float32))
    if entry is not None:
        w = _diag_w(4)
        w[entry] = 1e-30
    p = tfb.pack_tail_g1(w)
    assert not p.diag and p.w is w
    assert torch.equal(p.kernel_w, w)


def test_pack_tail_g1_pads_a_narrow_dense_w():
    w = _diag_w(5)[:, :12].contiguous()
    p = tfb.pack_tail_g1(w)
    assert not p.diag and p.kernel_w.shape == (128, 128) and p.kernel_w.is_contiguous()
    assert torch.equal(p.kernel_w[:, :12], w) and not p.kernel_w[:, 12:].any()


@pytest.mark.parametrize("cout", [6, 130, 0])
def test_pack_tail_g1_refuses_a_cout_the_kernel_does_not_take(cout):
    with pytest.raises(ValueError, match="multiple of 4"):
        tfb.pack_tail_g1(torch.zeros(128, cout))


def test_fam_tail_apply_g1_refuses_a_packed_made_from_another_w():
    """Even a pack of equal values is refused: the packed form is tied to
    the very tensor the plain version reads."""
    x, ca, sa = (_t(a) for a in _tail_inputs(np.random.default_rng(6), 1, 3, 5))
    w = _diag_w(7)
    with pytest.raises(ValueError, match="packed"):
        tfb.fam_tail_apply_g1(x, ca, sa, w, packed=tfb.pack_tail_g1(w.clone()))
    got = tfb.fam_tail_apply_g1(x, ca, sa, w, packed=tfb.pack_tail_g1(w))
    torch.testing.assert_close(got, tfb.fam_tail_apply_g1_plain(x, ca, sa, w), rtol=0, atol=0)


def _bad_packs(w: torch.Tensor) -> dict:
    """Hand-made packs of `w` that the kernel would read out of bounds or
    misread: each refused before any launch."""
    good = tfb.pack_tail_g1(w)
    narrow = w[:, :12].contiguous()
    return {
        "diag with the dense layout": (w, tfb.TailG1Packed(w, w, True)),
        "dense with the diag layout": (w, tfb.TailG1Packed(w, good.kernel_w, False)),
        "a transposed layout": (w, tfb.TailG1Packed(w, good.kernel_w.t(), True)),
        "a float64 layout": (w, tfb.TailG1Packed(w, good.kernel_w.double(), True)),
        "diag at Cout 12": (narrow, tfb.TailG1Packed(narrow, good.kernel_w, True)),
    }


@pytest.mark.parametrize("case", list(_bad_packs(_diag_w(10))))
def test_fam_tail_apply_g1_refuses_a_packed_of_the_wrong_layout(case):
    w, packed = _bad_packs(_diag_w(10))[case]
    x, ca, sa = (_t(a) for a in _tail_inputs(np.random.default_rng(11), 1, 2, 3))
    with pytest.raises(ValueError, match="packed"):
        tfb.fam_tail_apply_g1(x, ca, sa, w, packed=packed)


def test_fam_tail_apply_g1_does_not_inspect_an_unpacked_w(monkeypatch):
    """Without ``packed=`` the call lays w out for the dense instance: it
    never runs the quadrant-diagonal test that ``pack_tail_g1`` runs once."""

    def no_inspect(w):
        raise AssertionError("w inspected on a call")

    monkeypatch.setattr(tfb, "_is_quadrant_diagonal", no_inspect)
    x, ca, sa = (_t(a) for a in _tail_inputs(np.random.default_rng(12), 1, 2, 3))
    w = _diag_w(13)
    torch.testing.assert_close(tfb.fam_tail_apply_g1(x, ca, sa, w), tfb.fam_tail_apply_g1_plain(x, ca, sa, w))
    dense = tfb._dense_tail_g1(w)
    assert not dense.diag and dense.w is w and torch.equal(dense.kernel_w, w)


def test_packed_forward_packs_k6_once_per_model(packed_model, monkeypatch):
    """A forward packs nothing: K6 gets the folds packed in __init__, each
    with the very w it was made from."""
    from retinex_tpu_torch.models import packed_inference

    seen = []

    def no_pack(w):
        raise AssertionError("pack_tail_g1 called during a forward")

    def spy(x, ca_vec, sa, w, packed=None):
        seen.append((w, packed))
        return tfb.fam_tail_apply_g1(x, ca_vec, sa, w, packed=packed)

    monkeypatch.setattr(packed_inference, "pack_tail_g1", no_pack)
    monkeypatch.setattr(packed_inference, "fam_tail_apply_g1", spy)
    packed_model(torch.rand(1, 64, 64, 3))
    folds = (packed_model.fold_f1, packed_model.fold_f2)
    assert len(seen) == 2
    assert all(p is f and w is f.w for (w, p), f in zip(seen, folds))


@pytest.mark.parametrize("b,h,w", [(1, 8, 64), (2, 8, 64)])
def test_fam_tail_apply_g1_plain_at_a_quadrant_diagonal_w_matches_pallas(b, h, w):
    x, ca, sa = _tail_inputs(np.random.default_rng(8), b, h, w)
    wd = _diag_w(9)
    want = jfb.fam_tail_apply_g1(*(jnp.asarray(a) for a in (x, ca, sa, wd.numpy())), interpret=True)
    got = tfb.fam_tail_apply_g1_plain(_t(x), _t(ca), _t(sa), wd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------- K2's plan


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("tiles", [2, 4, 8, 16])
def test_k2_strips_cover_every_sampled_row_once(tiles, s):
    """At 1088 rows (and a ragged 272), batch 1 and 8: the strips of
    tables_plan, walked as the kernel walks them, read each tile row whose
    in-cell index is a multiple of s exactly once, and no other."""
    for h in (1088, 272):
        hh = h // (2 * tiles)
        want = [r for r in range(2 * hh) if (r % hh) % s == 0]
        for batch in (1, 8):
            strips, rows = cg.tables_plan(h, tiles, tiles, s, batch)
            got = [r for k in range(strips) for r in cg.strip_rows(h, tiles, s, k, rows)]
            assert got == want
            assert all(cg.strip_rows(h, tiles, s, k, rows) for k in range(strips))  # no empty strip


def test_k2_plan_fills_the_card():
    """About four blocks per SM at the main path's 8x8 tiles, batch 1."""
    strips, rows = cg.tables_plan(1088, 8, 8, 1, 1, n_sm=132)
    assert 4 * 132 <= 64 * strips <= 8 * 132
    assert cg.tables_plan(1088, 8, 8, 1, 8, n_sm=132)[0] >= 2


@pytest.mark.parametrize(
    "shape,tiles,want", [((1, 1088, 1920), 8, 16), ((1, 1088, 1920), 16, 4), ((3, 272, 496), 8, 1)]
)
def test_k2_load_width(shape, tiles, want):
    plane = torch.zeros(shape, dtype=torch.uint8)
    assert cg._load_width(plane, shape[1] * shape[2], shape[2], tiles) == want
    lab = torch.zeros((shape[0], 3) + shape[1:], dtype=torch.uint8)
    assert cg._load_width(lab[:, 0], 3 * shape[1] * shape[2], shape[2], tiles) == want
