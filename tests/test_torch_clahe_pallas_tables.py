"""K16's tables and quantiser, on the CPU.

K16's two kernels (``csrc/clahe_lab.cu`` lab_hist_kernel and
clahe_apply_kernel in its K16 mode) read what depends on one byte from
tables built by the plain version's own operations (``ops/clahe_pallas.py``;
the de-gamma on the kernel's card, the others on the host), and quantise linear light to the sRGB byte with
K3's quantiser. These tests hold that arithmetic, emulated here in PyTorch
as the kernels compute it, to the plain version:

- the de-gamma table against the plain de-gamma of every quantised byte,
  and the forward half read from it, as the first kernel reads it, against
  the plain version on a frame holding every byte in every channel;
- fy and Y by L against the plain expressions for every byte;
- the quantiser (``clahe_gather.quant_buckets``) against the plain
  version's own byte of linear light (``_srgb_byte``) on both sides of
  every step and on a sample of each binade, negative light included: the
  two are one function;
- the apply half (the tables, the fused fx and fz, f^-1 with its product
  by 1/7.787, the quantiser, the float output byte * (1/255)) against
  ``clahe_pallas_apply_plain``'s Lab -> sRGB on seeded Lab triples.

The kernels themselves are held to the plain version, on the card and on
the CPU, by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from retinex_tpu_torch.ops import clahe_gather as cg
from retinex_tpu_torch.ops import clahe_pallas as kp

RC255 = np.float32(1.0) / np.float32(255.0)


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: PyTorch's CPU pow rounds a tensor's last len % 32
    elements (a scalar pow) differently from the rest, and a parallel loop
    gives each thread's range its own last elements; the lengths here are
    whole vectors."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _kernel_byte(lin: torch.Tensor) -> torch.Tensor:
    """csrc/clahe_lab.cu srgb_byte: one bucket lookup and one compare."""
    quant = cg.apply_tables()["quant"]
    bits = lin.view(torch.int32)
    e = quant[torch.clamp((bits >> 16) - cg.QUANT_BASE, 0, cg.QUANT_LAST).long()]
    return (e >> 17) + ((bits & 0xFFFF).long() >= (e & 0x1FFFF)).long()


def _srgb_byte(lin: torch.Tensor) -> torch.Tensor:
    """The plain version's output byte of linear light, as its apply half
    rounds it: round(clamp(sRGB(max(lin, 0)), 0, 1) * 255)."""
    return torch.round(torch.clamp(kp._linear_to_srgb(lin), 0.0, 1.0) * 255.0)


def test_degamma_table_is_the_plain_de_gamma_of_every_byte():
    v = torch.arange(256, dtype=torch.float32)
    xq = torch.round(torch.clamp(v / 255.0, 0.0, 1.0) * 255.0) * kp._rc(255.0)
    want = torch.where(xq <= 0.04045, xq * kp._rc(12.92), ((xq + 0.055) * kp._rc(1.055)) ** 2.4)
    assert torch.equal(kp.degamma_table_k16("cpu"), want)


def test_forward_from_the_table_equals_the_plain_operations():
    """The forward half as the first kernel computes it, the de-gamma of
    each quantised byte read from the table and then K16's operations (the
    matrix, the cube root as a float pow, the fused Lab scalings), equals
    clahe_pallas_hist_plain, which runs the power law on every pixel, on a
    [1, 64, 96, 3] frame whose pixels run through every byte in each channel
    (three channel orders)."""
    v = torch.arange(256 * 24) % 256
    x = torch.stack([v, (v * 7 + 3) % 256, (v * 13 + 11) % 256], dim=-1).float().reshape(1, 64, 96, 3) / 255.0
    want, _ = kp.clahe_pallas_hist_plain(x)
    q = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).long()
    tab = kp.degamma_table_k16("cpu")
    lab = kp._lab_u8scale_of_linear(tab[q[..., 0]], tab[q[..., 1]], tab[q[..., 2]])
    got = torch.stack([torch.clamp(torch.round(ch), 0.0, 255.0) for ch in lab], dim=1).to(torch.uint8)
    assert torch.equal(got, want)


def test_fy_and_y_tables_are_the_plain_expressions_for_every_byte():
    t = kp.apply_tables_k16()
    L = torch.arange(256, dtype=torch.float32)
    fy = (L * (100.0 / 255.0) + 16.0) * kp._rc(116.0)
    assert torch.equal(t["fy"], fy)
    assert torch.equal(t["y"], torch.where(fy > 6.0 / 29.0, fy * fy * fy, (fy - 16.0 / 116.0) * kp._rc(7.787)))
    assert torch.equal(t["quant"], cg.apply_tables()["quant"])


def test_quantiser_is_k16s_byte_at_every_step():
    """For every byte k, the least f32 that K3's quantiser takes to k
    (srgb_thresholds) gives k under K16's own byte, and the f32 just below
    it k - 1; the quantiser equals K16's byte on every 97th bit pattern of
    [0, 1.25] and on negative light (byte 0)."""
    steps = cg.srgb_thresholds()[1:256]
    bits = torch.cat([steps, steps - 1]).to(torch.int32)
    bits = torch.cat([bits, bits[-1:].expand((-bits.numel()) % 32)])
    byte = _srgb_byte(bits.view(torch.float32))[:510].long()
    k = torch.arange(1, 256)
    assert torch.equal(byte[:255], k) and torch.equal(byte[255:], k - 1)
    sample = torch.arange(0, int(np.float32(1.25).view(np.int32)), 97 * 32, dtype=torch.int64)
    sample = (sample[:, None] + torch.arange(32)).reshape(-1).to(torch.int32)
    negative = -torch.rand(1 << 12, generator=torch.Generator().manual_seed(0))
    for lin in (sample.view(torch.float32), negative):
        assert torch.equal(_kernel_byte(lin), _srgb_byte(lin).long())


def test_apply_from_the_tables_equals_the_plain_version():
    """K16's Lab -> sRGB as its kernel computes it from fy and Y by L, the
    fused fx and fz, f^-1's product by 1/7.787, the quantiser and the float
    output byte * (1/255), equal to clahe_pallas_apply_plain's on 2^16 seeded
    Lab triples (its blend left out: identity LUTs keep L)."""
    rng = np.random.default_rng(4)
    lab = torch.from_numpy(rng.integers(0, 256, (1, 3, 256, 256), dtype=np.uint8))
    luts = torch.arange(256, dtype=torch.uint8).expand(1, 8, 8, 256).contiguous()
    want = kp.clahe_pallas_apply_plain(lab, luts)
    t = kp.apply_tables_k16()
    L, a, b = (lab[:, c].long() for c in range(3))
    fy, y = t["fy"][L], t["y"][L]
    fx = kp._fma(a.float() - 128.0, torch.full_like(fy, kp._rc(500.0)), fy)
    fz = kp._fma(128.0 - b.float(), torch.full_like(fy, kp._rc(200.0)), fy)
    X, Z = kp._lab_f_inv(fx) * kp._XN, kp._lab_f_inv(fz) * kp._ZN
    got = torch.stack(
        [_kernel_byte(m[0] * X + m[1] * y + m[2] * Z).float() * float(RC255) for m in kp._XYZ2RGB], dim=-1
    )
    assert torch.equal(got, want), f"{int((got != want).sum())} values differ"
