"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so without a card these
tests skip (decided in a fixture). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only the port's
dependencies, without the repository's conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import dataclasses

import pytest
import torch

from retinex_tpu_torch.ops import clahe_gather as cg


@dataclasses.dataclass
class _Frame:
    rgb: torch.Tensor
    lab: torch.Tensor
    luts: torch.Tensor


@pytest.fixture
def cuda_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    rgb = torch.randint(0, 256, (2, 3, 272, 480), dtype=torch.uint8, device="cuda", generator=g)
    lab = cg.lab_fwd_u8_plain(rgb)
    return _Frame(rgb, lab, cg.clahe_tables_plain(lab))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_frame):
    f = cuda_frame
    cg.reset_launches()
    lab = cg.lab_fwd_u8(f.rgb)
    luts = [cg.clahe_tables(f.lab, hist_subsample=s) for s in (1, 2)]
    out = cg.clahe_apply_u8(f.lab, f.luts)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == {"lab_fwd_u8": 1, "clahe_tables": 2, "clahe_apply_u8": 1}
    for got, want in ((lab, f.lab), (out, cg.clahe_apply_u8_plain(f.lab, f.luts))):
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-4
    assert torch.equal(luts[0], f.luts)
    assert torch.equal(luts[1], cg.clahe_tables_plain(f.lab, hist_subsample=2))
