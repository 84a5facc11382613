"""The FLOP and byte functions against counts made by hand."""

from __future__ import annotations

import pytest

from portbench.counts import flops, kernels, peaks


def conv_macs(cin, cout, k, h, w):
    return cin * cout * k * k * h * w


def fam_macs(f, h, w):
    return (2 * conv_macs(f, f, 1, h, w) + 4 * conv_macs(f, f, 3, h, w) + conv_macs(4 * f, f, 1, h, w)
            + conv_macs(f, f // 16, 1, 1, 1) + conv_macs(f // 16, f, 1, 1, 1) + conv_macs(2, 1, 7, h, w))


def block_macs(cin, cout, h, w, stride, preact):
    ho, wo = h // stride, w // stride
    m = conv_macs(cin, cout, 3, ho, wo) + conv_macs(cout, cout, 3, ho, wo)
    if stride != 1 or cin != cout:
        m += conv_macs(cin, cout, 1, ho, wo)
    return m


def up_macs(cin, cout, h, w):
    return conv_macs(cin, cout, 2, h, w) + 2 * conv_macs(cout, cout, 3, 2 * h, 2 * w)


def net_macs(h, w, aspp):
    """The standard forward's multiply-adds, layer by layer."""
    m = conv_macs(3, 32, 3, h, w)
    m += block_macs(32, 64, h, w, 2, False) + block_macs(64, 128, h // 2, w // 2, 2, False)
    m += block_macs(128, 256, h // 4, w // 4, 2, False)
    h8, w8 = h // 8, w // 8
    m += 2 * block_macs(256, 256, h8, w8, 1, False)
    if aspp:
        m += conv_macs(256, 256, 1, h8, w8) + 3 * conv_macs(256, 256, 3, h8, w8) + conv_macs(256, 256, 1, 1, 1)
        m += conv_macs(1280, 256, 1, h8, w8)
    m += up_macs(256, 128, h8, w8) + up_macs(128, 64, h // 4, w // 4) + up_macs(64, 32, h // 2, w // 2)
    m += conv_macs(32, 32, 3, h, w) + conv_macs(32, 1, 1, h, w)
    for div in (1, 4, 16):
        m += conv_macs(3, 32, 3, h // div, w // div) + fam_macs(32, h // div, w // div)
    return m + conv_macs(96, 32, 1, h, w) + conv_macs(32, 3, 1, h, w)


@pytest.mark.parametrize("aspp", [False, True])
@pytest.mark.parametrize("h, w", [(64, 96), (128, 128)])
def test_net_forward_flops(h, w, aspp):
    assert flops.net_forward(aspp, aspp, h, w) == 2 * net_macs(h, w, aspp)


def vgg_macs(h, w):
    """VGG19's convolutions to pool3 on one image."""
    return (conv_macs(3, 64, 3, h, w) + conv_macs(64, 64, 3, h, w) + conv_macs(64, 128, 3, h // 2, w // 2)
            + conv_macs(128, 128, 3, h // 2, w // 2) + conv_macs(128, 256, 3, h // 4, w // 4)
            + 3 * conv_macs(256, 256, 3, h // 4, w // 4))


def test_train_step_flops_by_hand():
    b, s = 2, 64
    net = net_macs(s, s, False)
    # the convolutions that read the input image need no input gradient
    first = conv_macs(3, 32, 3, s, s) * 2 + conv_macs(3, 32, 3, s // 4, s // 4) + conv_macs(3, 32, 3, s // 16, s // 16)
    # VGG19 on the enhanced image and the input, its input gradient on the enhanced one
    expected = 2 * b * (3 * net - first + 3 * vgg_macs(s, s))
    assert flops.train_step(False, False, b, s) == pytest.approx(expected, rel=1e-3)


def test_kernel_work_by_hand():
    work = kernels.forward_work(2, 64, 96)
    px = 2 * (64 * 96 + 16 * 24)
    assert work["K4"] == (2, px * 64 * 4, px * 2 * (2 * 32 * 32 + 4 * 9 * 32 * 32 + 128 * 32))
    assert work["K5"] == (2, px * 34 * 4, px * 96)
    assert work["K6"] == (2, px * 65 * 4, px * (64 + 2 * 32 * 32))
    assert work["K1"] == (1, 2 * 64 * 96 * 15, 0)
    assert work["K3"][1] == 2 * 64 * 96 * 15 + 2 * 64 * 256
    assert "K11" in kernels.forward_work(1, 1080, 1920) and "K6" not in kernels.forward_work(1, 1080, 1920)


def test_roofline_pct():
    work = kernels.forward_work(1, 64, 96)
    ops = {}
    for fam, (calls, nbytes, n_ops) in work.items():
        subs, counter = kernels.NAMES[fam]
        ops[f"void {counter}<4>(float*)"] = (calls, kernels.bound_s(nbytes, n_ops))
    assert kernels.roofline_pct(ops, 1, 64, 96) == pytest.approx(100.0)
    slower = {k: (n, 2 * s) for k, (n, s) in ops.items()}
    assert kernels.roofline_pct(slower, 1, 64, 96) == pytest.approx(50.0)
    assert kernels.roofline_pct({}, 1, 64, 96) is None
    assert kernels.bound_s(peaks.HBM_BYTES_PER_S, 0) == 1.0
