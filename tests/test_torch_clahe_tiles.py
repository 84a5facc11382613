"""Lab-CLAHE on frames that are not cell-divisible (G1), on the CPU.

On the card ``clahe.clahe_lab_rgb`` takes such a frame through K1's float
instance, K2 in its tile-row mode and K3 in its tile-coordinate mode
(``clahe_gather.clahe_lab_rgb_tiles``). These tests hold their plain
versions, and the host geometry K3 reads, to the JAX package and to the
port's own CPU route:

- the plain tile-row tables and tile-coordinate apply, on the JAX
  package's Lab bytes, equal ``retinex_tpu.ops.clahe.clahe_lab_rgb`` byte
  for byte but where XLA's CPU pow and PyTorch's round one linear light to
  two bytes (each such value named by its Lab triple and checked to be
  that); composed after K1's plain version they equal the port's plain
  route byte for byte; seeded frames with exact .5 ties;
- ``row_bands`` and ``tile_geometry`` (the band table, each row's and
  column's weight and tile pair) equal ``clahe._interp_maps``;
- the kernel's blend, emulated from that geometry as the kernel reads it,
  equals ``clahe.blend_tiles``;
- K3's table Lab -> sRGB, emulated as the kernel computes it, equals
  ``colorspace.lab_u8_to_rgb`` rounded to bytes on a seeded sample of Lab
  triples.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import clahe as jc
from retinex_tpu.ops import colorspace as jcs
from retinex_tpu_torch.ops import clahe as tc
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops.colorspace import XN, XYZ2RGB, ZN, lab8_to_linear_rgb, lab_u8_to_rgb

SHAPES = [(1, 264, 480, 3), (1, 270, 480, 3), (2, 57, 41, 3), (1, 72, 104, 3)]
GEOMETRY_SHAPES = [(264, 480), (270, 480), (57, 41), (72, 104), (1080, 1920), (1001, 1503)]


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: PyTorch's CPU pow rounds a tensor's last len % 32
    elements (a scalar pow) differently from the rest, and a parallel loop
    gives each thread's range its own last elements."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _frame(shape, seed: int) -> np.ndarray:
    """Seeded float NHWC frame: uniform, every 53rd value an exact .5 tie of
    the quantisation, a few values past [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    flat = x.reshape(-1)
    flat[::53] = (rng.integers(0, 255, flat[::53].size) + 0.5).astype(np.float32) / np.float32(255.0)
    flat[::211] = 1.2
    flat[::307] = -0.1
    return x


def _jax_lab(x: np.ndarray) -> torch.Tensor:
    """The Lab bytes the JAX package's clahe_lab_rgb computes on the CPU
    (its quantisation, then rgb_to_lab_u8 rounded), planar u8 [B,3,H,W]."""
    xq = jnp.round(jnp.clip(jnp.asarray(x), 0.0, 1.0) * 255.0) / 255.0
    lab = np.array(jnp.clip(jnp.round(jcs.rgb_to_lab_u8(xq)), 0, 255).astype(jnp.uint8))
    return torch.from_numpy(lab).permute(0, 3, 1, 2).contiguous()


def _pow_points(lab: torch.Tensor, luts: torch.Tensor, got: np.ndarray, want: np.ndarray) -> list[str]:
    """Each value where got and want differ, named by its Lab triple after the
    blend; raises unless PyTorch's CPU sRGB byte (``srgb_byte_plain``, the
    port's) and XLA's (``linear_to_srgb`` of the JAX package, jitted as its
    route runs it) of the same linear light are exactly got's and want's."""
    L2 = tc.blend_tiles(lab[:, 0], luts)
    named = []
    for b, i, j, c in zip(*np.nonzero(got != want)):
        triple = (int(L2[b, i, j]), int(lab[b, 1, i, j]), int(lab[b, 2, i, j]))
        lin = lab8_to_linear_rgb(*(torch.tensor([float(t)] * 32) for t in triple))[c]
        xla = float(np.round(np.clip(np.asarray(jax.jit(jcs.linear_to_srgb)(jnp.asarray(lin.numpy())))[0], 0, 1) * 255))
        port = float(cg.srgb_byte_plain(lin)[0])
        msg = (f"image {b}, pixel ({i}, {j}), channel {c}: Lab triple {triple}, lin {float(lin[0])!r}; "
               f"got {got[b, i, j, c] * 255:.1f}, want {want[b, i, j, c] * 255:.1f}; PyTorch's byte {port}, XLA's {xla}")
        assert (port, xla) == (round(got[b, i, j, c] * 255), round(want[b, i, j, c] * 255)), msg
        named.append(msg)
    return named


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_modes_compose_to_the_jax_route(shape):
    """K2's tile-row plain version and K3's tile-coordinate plain version,
    on the JAX package's own Lab bytes, equal its clahe_lab_rgb byte for
    byte but where XLA's CPU pow and PyTorch's round the same linear light
    to two bytes (each such value named; ROADMAP, divergences)."""
    assert not tc.cell_divisible(shape[1], shape[2], 8, 8)
    x = _frame(shape, seed=sum(shape))
    lab = _jax_lab(x)
    luts = cg.clahe_tables_tiles_plain(lab)
    got = cg.clahe_apply_tiles_f32_nhwc_plain(lab, luts).numpy()
    want = np.asarray(jc.clahe_lab_rgb(jnp.asarray(x), use_pallas=False))
    for msg in _pow_points(lab, luts, got, want):
        print("XLA's pow and PyTorch's part at", msg)


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_modes_equal_the_ports_plain_route(shape):
    """K1's plain version -> K2's tile-row plain version -> K3's
    tile-coordinate plain version equals the port's plain CPU route (the
    bytes the card is held to) byte for byte, and so does the wrapper on a
    CPU tensor."""
    xt = torch.from_numpy(_frame(shape, seed=sum(shape)))
    lab = cg.lab_fwd_f32_nhwc_plain(xt)
    got = cg.clahe_apply_tiles_f32_nhwc_plain(lab, cg.clahe_tables_tiles_plain(lab))
    want = tc.clahe_lab_rgb(xt)
    assert torch.equal(got, want), f"{int((got != want).sum())} values differ"
    assert torch.equal(cg.clahe_lab_rgb_tiles(xt), got)


@pytest.mark.parametrize("shape", [(2, 57, 41), (1, 270, 480)])
def test_tile_row_tables_are_clahe_u8s(shape):
    """K2's tile-row plain version on a u8 plane equals the tables clahe_u8
    builds (the padded tiles' histograms, _luts_from_hist), on the L plane
    of planar Lab and on a [B, H, W] plane alike."""
    rng = np.random.default_rng(1)
    plane = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    hist, area = tc.padded_tile_hist(plane, 8, 8)
    want = tc._luts_from_hist(hist, 2.0, area).to(torch.uint8)
    assert torch.equal(cg.clahe_tables_tiles_plain(plane), want)
    lab = torch.stack([plane, plane, plane], dim=1).contiguous()
    assert torch.equal(cg.clahe_tables_tiles(lab), want)


@pytest.mark.parametrize("hw", GEOMETRY_SHAPES)
def test_row_bands_and_geometry_are_interp_maps(hw):
    """The host's row-band plan is _interp_maps' runs of one (y0i, y1i)
    pair, and tile_geometry's bands cut those runs in order; its ya, xa and
    x pairs are _interp_maps' at every row and column, for several grids."""
    h, w = hw
    _, _, tile_h, tile_w = tc.tile_dims(h, w, 8, 8)
    (y0i, y1i, ya), (x0i, x1i, xa) = tc._interp_maps(h, w, 8, 8, tile_h, tile_w)
    runs = cg.row_bands(h, w, 8, 8)
    assert runs[0][0] == 0 and runs[-1][1] == h
    for (r0, r1, t0, t1), nxt in zip(runs, runs[1:] + [None]):
        assert bool((y0i[r0:r1] == t0).all()) and bool((y1i[r0:r1] == t1).all())
        if nxt is not None:
            assert nxt[0] == r1 and (nxt[2], nxt[3]) != (t0, t1)
    for batch, vec, n_sm in ((1, 4, 132), (8, 4, 132), (2, 1, 16)):
        block, bands, rows_par = cg.tile_geometry(h, w, 8, 8, batch, vec, n_sm, "cpu")
        table = block[: 4 * bands].reshape(bands, 4)
        assert int(table[0, 0]) == 0 and int(table[-1, 1]) == h
        assert torch.equal(table[1:, 0], table[:-1, 1]) and bool((table[:, 1] > table[:, 0]).all())
        for r0, r1, t0, t1 in table.tolist():
            assert bool((y0i[r0:r1] == t0).all()) and bool((y1i[r0:r1] == t1).all())
        col_blocks = -(-(w // vec) // 256)
        assert bands * col_blocks * batch <= max(len(runs) * col_blocks * batch, n_sm)
        assert 1 <= rows_par <= cg.K3_ROWS_PAR
        assert torch.equal(block[4 * bands : 4 * bands + h].view(torch.float32), ya)
        assert torch.equal(block[4 * bands + h : 4 * bands + h + w].view(torch.float32), xa)
        pair = block[4 * bands + h + w :].long()
        assert torch.equal(torch.clamp(pair - 1, min=0), x0i) and torch.equal(torch.clamp(pair, max=7), x1i)


def _emulated_tile_blend(l_u8: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """csrc/clahe_lab.cu clahe_apply_kernel<*, *, kTiles>'s new L: per band
    its two LUT rows, per column its x pair's neighbour tiles and xa, per
    row ya, all read from tile_geometry; the three fmas of clahe_u8."""
    b, h, w = l_u8.shape
    block, bands, _ = cg.tile_geometry(h, w, 8, 8, b, 1, 132, "cpu")
    ya_all = block[4 * bands : 4 * bands + h].view(torch.float32)
    xa = block[4 * bands + h : 4 * bands + h + w].view(torch.float32)
    pair = block[4 * bands + h + w :].long()
    t0x, t1x = torch.clamp(pair - 1, min=0), torch.clamp(pair, max=7)
    xb = 1.0 - xa
    out = torch.empty((b, h, w), dtype=torch.int32)
    v = l_u8.long()
    for r0, r1, t0y, t1y in block[: 4 * bands].reshape(bands, 4).tolist():
        vv = v[:, r0:r1]
        lut = lambda ty, tx: luts[:, ty][torch.arange(b)[:, None, None], tx[None, None, :], vv].float()  # noqa: E731
        l00, l01, l10, l11 = lut(t0y, t0x), lut(t0y, t1x), lut(t1y, t0x), lut(t1y, t1x)
        ya = ya_all[r0:r1][None, :, None]
        top = tc._fma(l00, xb, l01 * xa)
        bot = tc._fma(l10, xb, l11 * xa)
        out[:, r0:r1] = torch.clamp(torch.round(tc._fma(top, 1.0 - ya, bot * ya)), 0, 255).to(torch.int32)
    return out


@pytest.mark.parametrize("shape", [(2, 57, 41), (1, 270, 480), (1, 72, 104)])
def test_emulated_kernel_blend_equals_clahe_u8_blend(shape):
    rng = np.random.default_rng(2)
    l_u8 = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    luts = torch.from_numpy(rng.integers(0, 256, (shape[0], 8, 8, 256), dtype=np.uint8))
    assert torch.equal(_emulated_tile_blend(l_u8, luts), tc.blend_tiles(l_u8, luts))


def _kernel_byte(lin: torch.Tensor) -> torch.Tensor:
    """csrc/clahe_lab.cu srgb_byte: one bucket lookup and one compare."""
    quant = cg.apply_tables()["quant"]
    bits = lin.view(torch.int32)
    e = quant[torch.clamp((bits >> 16) - cg.QUANT_BASE, 0, cg.QUANT_LAST).long()]
    return (e >> 17) + ((bits & 0xFFFF).long() >= (e & 0x1FFFF)).long()


def test_k3_tables_equal_lab_u8_to_rgb_on_a_sample():
    """K3's Lab -> sRGB from its tables (fy, Y, (a - 128)/500, (b - 128)/200,
    f^-1 and the quantiser), emulated as the kernel computes it, equals
    lab_u8_to_rgb rounded to bytes on 2^16 seeded Lab triples."""
    rng = np.random.default_rng(3)
    lab = torch.from_numpy(rng.integers(0, 256, (1 << 16, 3)).astype(np.int64))
    want = torch.round(lab_u8_to_rgb(lab.float()) * 255.0).long()
    t = cg.apply_tables()
    fy, y = t["fy"][lab[:, 0]], t["y"][lab[:, 0]]

    def f_inv(ft):
        return torch.where(ft > 6.0 / 29.0, ft * ft * ft, (ft - 16.0 / 116.0) / 7.787)

    X = f_inv(fy + t["da"][lab[:, 1]]) * XN
    Z = f_inv(fy - t["db"][lab[:, 2]]) * ZN
    got = torch.stack([_kernel_byte(m[0] * X + m[1] * y + m[2] * Z) for m in XYZ2RGB], dim=-1)
    bad = (got != want).any(dim=-1)
    assert not bool(bad.any()), f"{int(bad.sum())} triples differ, the first {lab[bad][0].tolist()}"


def test_lab_forward_parts_from_jax_only_at_rounding_ties():
    """F5 (ROADMAP, Queue 3): on 2^20 seeded sRGB triples, every Lab byte
    where the port's plain forward (the cube root rounded to nearest, which
    K1 on the card also gives) and the JAX package's CPU route (XLA's cbrt)
    part lies at a rounding tie: the two unrounded values sit on either
    side of k + 0.5, each within 1e-4 of it. Prints how many part."""
    from retinex_tpu_torch.ops.colorspace import degamma_table, linear_rgb_to_lab8, srgb_bytes_to_lab_u8

    rgb = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1 << 20, 3)))
    port = srgb_bytes_to_lab_u8(rgb, -1).long()
    tab = degamma_table("cpu")
    port_f = torch.stack(linear_rgb_to_lab8(*(tab[c] for c in rgb.unbind(-1))), dim=-1)
    jax_f = torch.from_numpy(np.array(jcs.rgb_to_lab_u8(jnp.asarray(rgb.numpy().astype(np.float32) / 255.0))))
    jax_b = torch.clamp(torch.round(jax_f), 0, 255).long()
    part = port != jax_b
    tie = torch.floor(torch.maximum(port_f, jax_f)) + 0.5
    at_tie = ((port_f - tie) * (jax_f - tie) <= 0) & ((port_f - tie).abs() < 1e-4) & ((jax_f - tie).abs() < 1e-4)
    print(f"F5: {int(part.sum())} of {part.numel()} Lab bytes part from the JAX package's")
    assert bool(at_tie[part].all()), f"triples parting away from a tie: {rgb[part.any(-1) & ~at_tie.all(-1)][:4].tolist()}"
