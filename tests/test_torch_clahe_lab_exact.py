"""K1's and K3's exact tables and their float instances, on the CPU.

K3 (``csrc/clahe_lab.cu`` clahe_apply_kernel) reads fy, Y, (a-128)/500,
(b-128)/200 and v/255 from 256-entry tables, and quantises linear light to
the sRGB byte with one bucket lookup and one compare
(``clahe_gather.quant_buckets``). These tests hold that arithmetic,
emulated here in PyTorch exactly as the kernel does it, to the plain
versions:

- the quantiser against ``srgb_byte_plain`` on every f32 where the byte
  steps, [2**-14, the least lin that gives 255], one binade a case; below
  2**-14 (where the byte is 0) on every 61st bit pattern, and on samples
  above and below 0;
- each table against the plain expression for every byte, and the
  float output's v / 255 (two FMAs after a product) against the IEEE
  quotient for every byte;
- the whole (L, a, b) cube through the emulated kernel against
  ``clahe_apply_u8_plain`` with identity LUTs, an eighth of the cube a case;
- the float route's quantisation and division by 255 against the JAX
  package's glue, with .5 ties and values past [0, 1], and
  ``clahe_lab_rgb_gather`` against the JAX package's route.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import clahe as jc
from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops.colorspace import XN, XYZ2RGB, ZN

F32 = np.float32
ONE_BITS = int(np.float32(1.0).view(np.int32))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: PyTorch's CPU pow rounds a tensor's last len % 32
    elements (a scalar pow) differently from the rest (vectors), and a
    parallel loop gives each thread's range its own last elements; on one
    thread the plain bytes below depend only on the lengths chosen here."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def kernel_byte(lin: torch.Tensor) -> torch.Tensor:
    """csrc/clahe_lab.cu srgb_byte: the bucket of lin's top 16 bits, then
    one compare of its low 16 bits with the bucket's step."""
    quant = cg.apply_tables()["quant"]
    bits = lin.view(torch.int32)
    e = quant[torch.clamp((bits >> 16) - cg.QUANT_BASE, 0, cg.QUANT_LAST).long()]
    return (e >> 17) + ((bits & 0xFFFF).long() >= (e & 0x1FFFF)).long()


def _check_bits(lo: int, hi: int, step: int = 1) -> None:
    for start in range(lo, hi, step << 22):
        bits = torch.arange(start, min(start + (step << 22), hi), step, dtype=torch.int32)
        lin = bits.view(torch.float32)
        want = cg.srgb_byte_of_bits(bits).long()
        got = kernel_byte(lin)
        bad = torch.nonzero(got != want)
        assert bad.numel() == 0, f"lin {float(lin[bad[0]])}: kernel byte {int(got[bad[0]])}, plain {int(want[bad[0]])}"


def test_quantiser_reaches_255_below_one():
    t = cg.srgb_thresholds()
    assert t.shape == (257,) and bool((t[1:] > t[:-1]).all())
    assert int(t[255]) < ONE_BITS and float(cg.srgb_byte_plain(torch.tensor(1.0))) == 255.0


@pytest.mark.parametrize("exponent", range(-14, 0))
def test_quantiser_equals_plain_byte_over_every_f32_of_a_binade(exponent):
    """Every f32 in [2**e, 2**(e+1)), up to the least lin that gives 255."""
    lo = int(np.float32(2.0**exponent).view(np.int32))
    hi = min(lo + (1 << 23), int(cg.srgb_thresholds()[255]) + 1)
    _check_bits(lo, hi)


def test_quantiser_equals_plain_byte_below_the_binades_and_outside():
    """[0, 2**-14) on every 61st bit pattern; negatives, lin past the 255
    step and past 1.0 on samples."""
    _check_bits(0, int(np.float32(2.0**-14).view(np.int32)), step=61)
    g = torch.Generator().manual_seed(0)
    samples = torch.cat([
        -torch.rand(100_000, generator=g) * 10.0 ** torch.randint(-30, 3, (100_000,), generator=g),
        torch.tensor([-0.0, 0.0, 0.0031308, 1.0, 1.5, 1e30]),
        torch.arange(int(cg.srgb_thresholds()[255]), ONE_BITS + 100_000, dtype=torch.int32).view(torch.float32),
    ])
    assert torch.equal(kernel_byte(samples), cg.srgb_byte_of_bits(samples.view(torch.int32)).long())


def _plain_tables() -> dict[str, np.ndarray]:
    """The expressions of csrc/clahe_lab.cu's parent kernel, in f32."""
    v = np.arange(256, dtype=F32)
    fy = (v * F32(100.0 / 255.0) + F32(16.0)) / F32(116.0)
    y = np.where(fy > F32(6.0 / 29.0), fy * fy * fy, (fy - F32(16.0 / 116.0)) / F32(7.787)).astype(F32)
    return {
        "fy": fy, "y": y, "da": (v - F32(128.0)) / F32(500.0), "db": (v - F32(128.0)) / F32(200.0),
    }


@pytest.mark.parametrize("name", ["fy", "y", "da", "db"])
def test_table_equals_plain_expression_for_every_byte(name):
    got = cg.apply_tables()[name].numpy()
    want = _plain_tables()[name]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_dequantise_table_equals_the_glue():
    """v / 255 by ``dequantise_nhwc`` (``ieee_div``) equals the JAX
    package's astype(f32) / 255 for every byte."""
    v = np.arange(256, dtype=np.uint8)
    want = np.asarray(jnp.asarray(v).astype(jnp.float32) / 255.0)
    got = cg.dequantise_nhwc(torch.from_numpy(v).reshape(1, 1, 16, 16).expand(1, 3, 16, 16))
    np.testing.assert_array_equal(got[0, :, :, 0].reshape(-1).numpy().view(np.int32), want.view(np.int32))


def _f32(x: Fraction) -> Fraction:
    """x rounded to the nearest f32, ties to even."""
    near = np.float32(float(x))
    cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
    best = min(cands, key=lambda y: (abs(Fraction(float(y)) - x), int(np.float32(y).view(np.int32)) & 1))
    return Fraction(float(best))


def test_div255_gives_the_ieee_quotient_for_every_byte():
    """csrc/clahe_lab.cu div255: q = v * (1/255), then fmaf(fmaf(-q, 255,
    v), 1/255, q), each step rounded once, equals v / 255 rounded for every
    byte (v * (1/255) alone does not, for 126 of them)."""
    r = _f32(Fraction(1, 255))
    plain_product_wrong = 0
    for v in range(256):
        q = _f32(v * r)
        plain_product_wrong += q != _f32(Fraction(v, 255))
        assert _f32(_f32(v - q * 255) * r + q) == _f32(Fraction(v, 255))
    assert plain_product_wrong == 126


def test_branch_free_f_inverse_gives_the_ieee_quotient():
    """csrc/clahe_lab.cu lab_f_inv_k3 below the threshold: q = x * (1/7.787),
    then fmaf(fmaf(-q, 7.787, x), 1/7.787, q), equals x / 7.787 rounded, for
    x = ft - 16/116 at every ft = fy + (a-128)/500 or fy - (b-128)/200 that
    K3 forms at or below 6/29 (the plain product alone does not)."""
    t = cg.apply_tables()
    fy, da, db = (t[k].numpy() for k in ("fy", "da", "db"))
    ft = np.unique(np.concatenate([(fy[:, None] + da[None, :]).ravel(), (fy[:, None] - db[None, :]).ravel()]))
    ft = ft[ft <= F32(6.0 / 29.0)]
    x = ft - F32(16.0 / 116.0)
    c = F32(7.787)
    r = Fraction(float(F32(1.0) / c))
    want = x / c
    assert len(x) == 21205
    wrong_products = 0
    for xi, wi in zip(x, want):
        q = _f32(Fraction(float(xi)) * r)
        wrong_products += q != Fraction(float(wi))
        assert _f32(_f32(Fraction(float(xi)) - q * Fraction(float(c))) * r + q) == Fraction(float(wi))
    assert wrong_products > 0


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    c = lambda x: torch.tensor(F32(x))  # noqa: E731
    return torch.where(ft > c(6.0 / 29.0), ft * ft * ft, (ft - c(16.0 / 116.0)) / c(7.787))


def kernel_apply(lab: torch.Tensor) -> torch.Tensor:
    """csrc/clahe_lab.cu clahe_apply_kernel's colour arithmetic after the
    blend (L2 given), from the tables; planar u8 [B,3,H,W] -> sRGB bytes."""
    t = cg.apply_tables()
    L2, a, b = (lab[:, c].long() for c in range(3))
    fy = t["fy"][L2]
    X = _lab_f_inv(fy + t["da"][a]) * torch.tensor(F32(XN))
    Y = t["y"][L2]
    Z = _lab_f_inv(fy - t["db"][b]) * torch.tensor(F32(ZN))
    m = [[torch.tensor(F32(v)) for v in row] for row in XYZ2RGB]
    return torch.stack([kernel_byte(m[c][0] * X + m[c][1] * Y + m[c][2] * Z) for c in range(3)], dim=1).to(torch.uint8)


@pytest.mark.parametrize("part", range(8))
def test_kernel_arithmetic_equals_plain_over_the_lab_cube(part):
    """The cube of every (L, a, b) triple, planar [1, 3, 4096, 4096], 512
    rows a case, with identity LUTs at 8x8 tiles (the blend keeps L):
    the emulated kernel equals clahe_apply_u8_plain byte for byte."""
    v = torch.arange(part * 512 * 4096, (part + 1) * 512 * 4096, dtype=torch.int32)
    lab = torch.stack([v >> 16, (v >> 8) & 255, v & 255]).to(torch.uint8).reshape(1, 3, 512, 4096)
    luts = torch.arange(256, dtype=torch.uint8).expand(1, 8, 8, 256).contiguous()
    want = cg.clahe_apply_u8_plain(lab, luts)
    assert torch.equal(kernel_apply(lab), want)


def _frame(shape, seed, channels_first):
    """A seeded float NHWC frame with values past [0, 1] and exact .5 ties,
    stored NHWC or channels first (as the nets' outputs are)."""
    b, h, w, _ = shape
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((b, 3, h, w), generator=g) * 1.4 - 0.2
    flat = base.view(-1)
    flat[::7] = (torch.randint(0, 255, (flat[::7].numel(),), generator=g).float() + 0.5) / 255.0
    x = base.permute(0, 2, 3, 1)
    return x if channels_first else x.contiguous()


@pytest.mark.parametrize("channels_first", [True, False])
@pytest.mark.parametrize("shape", [(1, 48, 80, 3), (2, 32, 64, 3)])
def test_float_instances_quantise_and_dequantise_as_the_glue(shape, channels_first):
    """K1's float instance quantises as the JAX package's glue
    (clip, round half to even, clip, u8) and as the kernel's
    rint(min(max(x, 0), 1) * 255); K3's writes the u8 bytes / 255."""
    x = _frame(shape, 5, channels_first)
    q = cg.quantise_planar_u8(x)
    glue = np.asarray(jnp.clip(jnp.round(jnp.clip(jnp.asarray(x.numpy()).transpose(0, 3, 1, 2), 0.0, 1.0) * 255.0), 0, 255)
                      .astype(jnp.uint8))
    np.testing.assert_array_equal(q.numpy(), glue)
    xs = x.permute(0, 3, 1, 2).numpy()
    np.testing.assert_array_equal(np.rint(np.minimum(np.maximum(xs, F32(0)), F32(1)) * F32(255)).astype(np.uint8), glue)
    assert torch.equal(cg.lab_fwd_f32_nhwc(x), cg.lab_fwd_u8_plain(q))
    lab = cg.lab_fwd_u8_plain(q)
    luts = cg.clahe_tables_plain(lab)
    out = cg.clahe_apply_f32_nhwc(lab, luts)
    want = np.asarray(jnp.asarray(cg.clahe_apply_u8_plain(lab, luts).numpy()).astype(jnp.float32) / 255.0).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("channels_first", [True, False])
def test_float_route_matches_jax_route(channels_first):
    """clahe_lab_rgb_gather on the CPU equals the JAX package's CPU route
    on a frame stored either way, as tests/test_torch_clahe.py holds it,
    and equals the u8 planar route between the glue's two halves."""
    x = _frame((1, 48, 80, 3), 11, channels_first)
    got = cg.clahe_lab_rgb_gather(x)
    want = np.asarray(jc.clahe_lab_rgb(jnp.asarray(x.numpy()), use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), want)
    u8 = cg.clahe_rgb_u8_planar_gather(cg.quantise_planar_u8(x))
    assert torch.equal(got, (u8.to(torch.float32) / 255.0).permute(0, 2, 3, 1))


@pytest.mark.parametrize("widest", [8, 4])
@pytest.mark.parametrize(
    "h, w, tiles, vec", [(1088, 1920, 8, 8), (2160, 3840, 8, 8), (640, 640, 8, 8), (128, 64, 8, 4), (48, 80, 8, 1)]
)
def test_apply_plan(h, w, tiles, vec, widest):
    """K3's access width follows the cell width (at most `widest`: 8 for
    bytes out, 4 for floats); its bands stay inside a half-tile cell row,
    the grid within K3_BLOCKS_PER_SM blocks per SM (one band per cell row
    where even that is too many) and over half of it where the frame has
    enough rows."""
    lab = torch.zeros((1, 3, h, w), dtype=torch.uint8)
    vec = min(vec, widest)
    assert cg._apply_width(lab, w, tiles, widest) == vec
    hh = h // (2 * tiles)
    rows, rows_par = cg.apply_plan(h, w, tiles, 1, vec, n_sm=132)
    bands = -(-hh // rows)
    blocks = -(-(w // vec) // 256) * 2 * tiles * bands
    assert 1 <= rows <= hh and 1 <= rows_par <= min(rows, cg.K3_ROWS_PAR)
    assert blocks <= cg.K3_BLOCKS_PER_SM * 132 or bands == 1
    assert 2 * blocks > cg.K3_BLOCKS_PER_SM * 132 or rows == 1


def test_fwd_width():
    assert cg._fwd_width(256, 1088 * 1920, True) == 4
    assert cg._fwd_width(4, 1088 * 1920, False) == 4
    assert cg._fwd_width(4, 1088 * 1920, True) == 1
    assert cg._fwd_width(0, 37 * 53, False) == 1
