"""K6's dense bf16 instance on the tensor cores
(``fam_tail_apply_g1_wgmma_kernel``, ``retinex_tpu_torch/csrc/fam_tail_wgmma.cu``),
on the CPU.

The kernel runs only on the card, where tests/test_torch_cuda.py and
chip_smoke.py hold it to its plain version. Here:

- its B operand as shared memory holds it (``tail_g1_wgmma_b``, made once
  per model by ``pack_tail_g1`` for a dense w): read back at the byte
  addresses the kernel's descriptors give (piece, k chunk, column, the
  128-byte swizzle), with the columns put back in channel order, it is w's
  three bf16 pieces, which sum to w exactly, and zero past Cout; at Cout 4,
  36 and 128 (N 32, 64 and 128) and for a w whose entries span 2**-100 to
  2**100;
- its arithmetic, emulated: the scaled bf16 x (x * ca rounded, * sa
  rounded) against the three pieces read from that image, in the kernel's
  order (each k16 step's three pieces, the products exact in f32, the sums
  in f32), the columns put back, rounded to bf16 once: within one bf16 ulp
  of the plain version and of the JAX package's Pallas kernel in interpret
  mode on the same numpy-seeded inputs;
- the walk of a lane's rows over the persistent grid with one cached ca,
  reloaded where a row passes the cached image's end, gives every row its
  own image's ca;
- CPU tensors take the plain version and count no launch; a malformed pack
  is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.ops import fused_blocks as jfb
from retinex_tpu_torch.ops import fused_blocks as tfb

BF16 = torch.bfloat16
C, Q = 128, 32


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _within_one_ulp(got, want):
    """One bf16 ulp (2**-7 relative at most), or 2**-10 where the output is
    a small difference of larger terms (tests/test_torch_amp_kernels.py)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(jnp.asarray(got).astype(jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-10)


def _dense_w(cout: int, seed: int, wide: bool = False) -> torch.Tensor:
    """A seeded dense [128, cout] f32 w; `wide`: entries from 2**-100 to
    2**100 with all 24 significand bits set at random."""
    rng = np.random.default_rng(seed)
    if not wide:
        return _t(rng.standard_normal((C, cout)) * 0.05)
    mant = 1.0 + rng.integers(0, 2**23, (C, cout)) / 2**23
    return _t(np.ldexp(mant * rng.choice([-1.0, 1.0], (C, cout)), rng.integers(-100, 100, (C, cout))))


def _tail_inputs(rng, b, h, w):
    """x and sa rounded to bf16, ca_vec of bf16 values in f32."""
    x = _t(np.abs(rng.standard_normal((b, h, w, C))) * 0.4, BF16)
    ca_vec = _t(np.tile(1.0 / (1.0 + np.exp(-rng.standard_normal((b, Q)))), 4), BF16).float()
    sa = _t(1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, w, 4)))), BF16)
    return x, ca_vec, sa


def _read_b(image: torch.Tensor) -> torch.Tensor:
    """The kernel's B as its wgmma descriptors read it, [3 pieces, 128 k, N
    columns] (columns in the MMA's order): piece i, k = 64 kc + kr, column n
    at byte (2 i + kc) * N * 128 + n * 128 + ((kr // 8) ^ (n % 8)) * 16 +
    (kr % 8) * 2 of the image (the tile of piece i and k chunk kc, its row
    n, the 128-byte swizzle)."""
    n = image.shape[2]
    flat = image.reshape(-1)
    i, k, col = torch.meshgrid(torch.arange(3), torch.arange(C), torch.arange(n), indexing="ij")
    kc, kr = k // 64, k % 64
    byte = (2 * i + kc) * n * 128 + col * 128 + ((kr // 8) ^ (col % 8)) * 16 + (kr % 8) * 2
    return flat[byte // 2]


CASES = {"cout4": (4, False), "cout36": (36, False), "cout128": (128, False), "wide_range": (128, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_wgmma_b_unpacks_exactly_to_w(case):
    cout, wide = CASES[case]
    w = _dense_w(cout, seed=17 + cout, wide=wide)
    p = tfb.pack_tail_g1(w)
    n = tfb.wgmma_n_tile(cout)
    assert not p.diag and n == {4: 32, 36: 64, 128: 128}[cout]
    assert p.mma_w.shape == (3, 2, n, 64) and p.mma_w.dtype == BF16 and p.mma_w.is_contiguous()
    assert torch.equal(p.mma_w, tfb.tail_g1_wgmma_b(w))
    b = _read_b(p.mma_w)[..., tfb.mma_channels(n)]  # [3, k, channel]
    assert torch.equal(b[..., :cout], tfb.split_bf16x3(w))
    assert not b[..., cout:].float().any()
    assert torch.equal(b[..., :cout].double().sum(0), w.double())
    assert torch.equal(tfb._swizzle_128b(tfb._swizzle_128b(p.mma_w)), p.mma_w)  # its own inverse


def _k6_wgmma_emulated(x, ca_vec, sa, image, cout):
    """The kernel's arithmetic: the scaled bf16 x against B read from the
    image, the accumulators summing each k16 step's three piece products
    (exact in f32) in f32, the columns put back in channel order, rounded
    to bf16 once."""
    a = tfb.fam_tail_apply_plain(x, ca_vec, sa).float().reshape(-1, C)
    b = _read_b(image).float()
    acc = torch.zeros(a.shape[0], b.shape[2])
    for kk in range(8):
        ks = slice(16 * kk, 16 * kk + 16)
        for i in range(3):
            acc = acc + a[:, ks] @ b[i, ks]
    out = acc[:, tfb.mma_channels(b.shape[2])][:, :cout]
    return out.reshape(*x.shape[:3], cout).to(BF16)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (3, 5, 37)])
def test_k6_wgmma_arithmetic_within_one_ulp(case, b, h, w):
    """Within one bf16 ulp of the plain version; at the Pallas kernel's
    tile shape also of the JAX package's kernel in interpret mode."""
    cout, wide = CASES[case]
    x, ca_vec, sa = _tail_inputs(np.random.default_rng(23 + h), b, h, w)
    wd = _dense_w(cout, seed=29 + cout, wide=wide)
    got = _k6_wgmma_emulated(x, ca_vec, sa, tfb.pack_tail_g1(wd).mma_w, cout)
    assert got.dtype == BF16 and got.shape == (b, h, w, cout)
    want = tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, wd)
    if wide:  # the products span 2**-100 to 2**100: exactness, not a tolerance, is the point
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=0)
        return
    _within_one_ulp(got, want)
    if h == 8:
        jax_out = jfb.fam_tail_apply_g1(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(ca_vec.numpy()),
            jnp.asarray(sa.float().numpy()).astype(jnp.bfloat16), jnp.asarray(wd.numpy()), interpret=True,
        )
        _within_one_ulp(got, jax_out)


@pytest.mark.parametrize("n_pix,hw,grid", [(554_880 // 64, 5, 7), (1000, 37, 3), (64 * 9 + 5, 64, 2), (10, 3, 4)])
def test_ca_walk_gives_each_row_its_image(n_pix, hw, grid):
    """The kernel's walk: consumer warpgroup c of block blk takes the
    block's tiles blk + (c + 2 j) * grid of 64 rows; a lane holds rows
    16 warp + g and + 8 of each, scales them in that order and reloads its
    ca where a row reaches the cached image's end (rows past n_pix take the
    last image's). Every row in range gets its own image."""
    n_tiles = -(-n_pix // 64)
    for blk in range(grid):
        for c in range(2):
            for lane_row in range(0, 64, 5):  # a sample of the 32 x 4 lanes' row pairs
                first = lane_row % 8 + 16 * (lane_row // 16)
                img_end, img = -1, None
                for tile in range(blk + c * grid, n_tiles, 2 * grid):
                    for p in (tile * 64 + first, tile * 64 + first + 8):
                        if p >= img_end:
                            img = min(p, n_pix - 1) // hw
                            img_end = (img + 1) * hw
                        if p < n_pix:
                            assert img == p // hw


def test_cpu_tensors_take_the_plain_version():
    """bf16 dense calls, packed and not, at Cout 36 and 128 compute the plain
    version on CPU tensors and count no launch."""
    x, ca_vec, sa = _tail_inputs(np.random.default_rng(31), 2, 3, 5)
    tfb.reset_launches()
    for cout in (36, 128):
        wd = _dense_w(cout, seed=37)
        want = tfb.fam_tail_apply_g1_plain(x, ca_vec, sa, wd)
        for packed in (None, tfb.pack_tail_g1(wd)):
            torch.testing.assert_close(tfb.fam_tail_apply_g1(x, ca_vec, sa, wd, packed), want, rtol=0, atol=0)
    assert all(n == 0 for n in (*tfb.LAUNCHES.values(), *tfb.KERNEL_LAUNCHES.values(), *tfb.BF16_LAUNCHES.values()))


def _bad_dense_packs(w: torch.Tensor) -> dict:
    good = tfb.pack_tail_g1(w)
    narrow = tfb.pack_tail_g1(w[:, :36].contiguous())
    return {
        "no pieces": tfb.TailG1Packed(w, good.kernel_w, False, None),
        "f32 pieces": tfb.TailG1Packed(w, good.kernel_w, False, good.mma_w.float().contiguous()),
        "another N": tfb.TailG1Packed(w, good.kernel_w, False, narrow.mma_w),
        "unswizzled rows": tfb.TailG1Packed(w, good.kernel_w, False, good.mma_w.reshape(3, 2, 64, 128)),
        "diag-shaped pieces": tfb.TailG1Packed(w, good.kernel_w, False, torch.zeros(3, 4, Q, Q, dtype=BF16)),
    }


@pytest.mark.parametrize("case", list(_bad_dense_packs(_dense_w(C, 41))))
def test_malformed_dense_pack_is_refused(case):
    """A bf16 call reads ``mma_w``: a dense pack without it, or of another
    dtype or shape, is refused before any launch; an f32 call reads
    ``kernel_w`` and takes it."""
    w = _dense_w(C, 41)
    bad = _bad_dense_packs(w)[case]
    x, ca_vec, sa = _tail_inputs(np.random.default_rng(43), 1, 2, 3)
    with pytest.raises(ValueError, match="packed"):
        tfb.fam_tail_apply_g1(x, ca_vec, sa, w, packed=bad)
    f32 = tfb.fam_tail_apply_g1(x.float(), ca_vec, sa.float(), w, packed=bad)
    torch.testing.assert_close(f32, tfb.fam_tail_apply_g1_plain(x.float(), ca_vec, sa.float(), w), rtol=0, atol=0)
