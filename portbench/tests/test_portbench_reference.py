"""The frozen reference against the port's CPU path at a tiny size, so that
a drift of either shows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.common import weights
from portbench.reference import clahe, decode, net as rnet, train as rtrain


@pytest.mark.parametrize("arch", [False, True], ids=["cli", "preact_aspp"])
def test_net_matches_the_port(arch):
    from retinex_tpu_torch.models.packed_inference import PackedRetinex
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    spec = rnet.spec(arch, arch)
    model = MultiScaleUPRetinex(arch, arch)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: s for k, (s, _) in spec.items()}
    sd = weights.draw(spec, 2**31 + 3, "cpu")
    model.load_state_dict(sd)
    model.eval()
    x = torch.rand(2, 48, 80, 3, generator=torch.Generator().manual_seed(1))
    enh, illu = rnet.forward(sd, x, arch, arch)
    with torch.no_grad():
        p_enh, _, p_illu = PackedRetinex(model)(x)
    assert (p_enh - enh).abs().max() < 2e-6 and (p_illu - illu).abs().max() < 2e-6
    assert 0.05 < illu.std() / illu.mean()  # the drawn weights give a varied map


@pytest.mark.parametrize("h, w, most", [(72, 128, 0.0), (64, 96, 0.005)], ids=["tile_mode", "cell_mode"])
def test_lab_clahe_matches_the_port(h, w, most):
    """Frames that are not cell-divisible take the plain clahe_u8 route,
    byte for byte; cell-divisible ones the cell mode, whose blend weights
    round otherwise at a few ties."""
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    g = torch.Generator().manual_seed(2)
    x = torch.nn.functional.avg_pool2d(torch.rand(2, 3, h, w, generator=g) ** 2, 5, 1, 2).permute(0, 2, 3, 1)
    port = torch.round(clahe_lab_rgb(x.contiguous()) * 255).to(torch.uint8)
    ref = clahe.lab_clahe(x)
    off = (port.int() - ref.int()).abs()
    assert float((off > 0).float().mean()) <= most and int(off.max()) <= 2


@pytest.mark.parametrize("shape, target", [((144, 256), 256), ((200, 150), 128), ((1080, 1920), 1920), ((90, 160), None)])
def test_letterbox_matches_the_port(shape, target):
    from retinex_tpu_torch.data.native_loader import letterbox_into
    from retinex_tpu_torch.ops.letterbox import plan_letterbox

    img = np.random.default_rng(3).integers(0, 256, (*shape, 3), dtype=np.uint8)
    ref = decode.letterbox(img, target)
    if target is None:
        assert ref is img
        return
    plan = plan_letterbox(*shape, target, auto=True, scaleup=False)
    assert ref.shape == (plan.out_h, plan.out_w, 3)
    port = np.empty_like(ref)
    assert letterbox_into(img, target, True, False, port)
    assert np.abs(port.astype(int) - ref.astype(int)).max() <= 1


def test_train_step_matches_the_port():
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.losses.total import LossState
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
    from retinex_tpu_torch.train import trainer

    spec = rnet.spec(False, False)
    sd = weights.draw(spec, 11, "cpu")
    vgg = weights.draw(weights.vgg_spec(), 12, "cpu")
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        crit = trainer.build_criterion(Config(vgg_weights=weights.write_vgg_npz(vgg, f"{d}/v.npz")), torch.device("cpu"))
    model = MultiScaleUPRetinex(False, False)
    model.load_state_dict(sd)
    model.train()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    enh, refl, illu = model(x)
    total, _, _ = crit(x, enh, illu, refl, LossState.create())
    names = [k for k, (_s, kind) in spec.items() if kind in ("conv", "convT", "bias", "bn_w", "bn_b")]
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, [params[k] for k in names])
    ref_total, ref_grads, stats = rtrain.Step(sd, names, vgg, False, False).loss_and_grads(x)
    assert ref_total == pytest.approx(float(total.detach()), rel=1e-5)
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for k, g in zip(names, grads):
        assert (g - ref_grads[k]).abs().max() <= 1e-4 * scale, k
    for k, v in stats.items():
        assert torch.allclose(v, model.state_dict()[k], rtol=1e-5, atol=1e-7), k


def test_augment_matches_the_port():
    from retinex_tpu_torch.data.augment import augment_batch

    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (6, 16, 16, 3), dtype=np.uint8))
    port = augment_batch(u8, torch.Generator().manual_seed(9), basic=True)
    assert torch.equal(port, rtrain.augment(u8, torch.Generator().manual_seed(9)))
