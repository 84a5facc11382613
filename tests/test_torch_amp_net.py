"""The net in bf16 (``--use_amp``): each layer, both forwards and the CLI's
enhance and predict against the JAX package's ``dtype=jnp.bfloat16`` net.

Weights: the port's seeded untrained net with numpy-drawn BatchNorm
statistics, carried to Flax variables by the JAX package's converter. The
parameters stay f32 on both sides; each activation is rounded to bf16
where Flax rounds it (``retinex_tpu_torch/models/layers.py``).

Tolerances, each measured (at most twice the largest difference seen):

- Each layer against Flax run eagerly (op by op), whose operations round
  where the port's do: one bf16 ulp at the layer's largest output (rtol
  and atol 2**-7, the atol scaled by max |output|). An f32 sum taken in
  another order rounds the other way now and then, and a flip inside a
  block moves the block's later sums (seen: most layers bit-identical,
  the pre-activation stride-2 block one ulp on 5 % of its outputs).
- The forwards against the JAX package's jitted ones, the runs its CLI
  makes. XLA's CPU pipeline drops the bf16 rounding of a bf16 value that
  is promoted to f32 at once (``e_map ** 2``, ``illumination + epsilon``),
  and the packed forward on the CPU takes the XLA FAM route, not the
  Pallas kernels' rounding points; the flips of the layers add up. The
  standard forward: enhanced atol 8e-3, reflectance 2.1e-3, illumination
  1.9e-3 (seen 3.8e-3, 1.04e-3, 9.1e-4). The packed forward at 32x64
  (the fusion folds into K6) and 40x56 (it does not: K11 and the bf16
  resizes): enhanced 1.1e-2, reflectance 1.4e-2, illumination two ulps
  at 1, 2**-7 (seen 5.4e-3, 7.0e-3, and one ulp on 2.5 % of pixels).
- The output dtypes equal JAX's: the standard forward returns f32, f32,
  f32; the packed one f32, f32 and a bf16 illumination, which its PNG
  writers quantise in bf16 (ROADMAP, "Divergences inside the JAX
  package"): the port's bytes equal the JAX package's on every bf16 value.
- The CLI (``--use_amp``, enhance and predict, one image and a directory,
  the same ``.pth`` on both sides): the net's PNGs (predict's three,
  enhance's illumination) within 1 level on under 5 % of bytes (seen
  2.5 %, the illumination's one-ulp flips). Enhance's Lab-CLAHE on 8x8
  tiles of 8x8 pixels maps one level of its input to tens of levels, so
  its enhanced and comparison PNGs are bounded in mean level difference,
  under 0.45 (seen 0.24, with 16 levels at most, on 5.6 % of bytes).
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu import cli as jax_cli
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.models.convert import torch_state_dict_to_variables
from retinex_tpu.models.packed_inference import PackedRetinex as JaxPacked
from retinex_tpu_torch import cli
from retinex_tpu_torch.models.packed_inference import NetCfg, PackedRetinex
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

REPO = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
KINDS = ("enhanced", "illumination", "comparison")


def _port(use_preact=False, use_aspp=False, seed=0):
    """A bf16 port net: seeded weights, BatchNorm statistics from numpy."""
    model = cli.init_untrained(MultiScaleUPRetinex(use_preact, use_aspp, dtype=BF16), seed)
    rng = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32) * 0.1))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
            m.weight.data.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
            m.bias.data.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32) * 0.1))
    return model.eval()


def _jax(port):
    variables = torch_state_dict_to_variables(port.state_dict(), port.use_preact, port.use_aspp)
    return JaxNet(use_preact=port.use_preact, use_aspp=port.use_aspp, dtype=jnp.bfloat16), variables


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def nets():
    """{flags: (port net, JAX module, variables)} for the CLI's default
    flags and for pre-activation + ASPP."""
    out = {}
    for flags in ((False, False), (True, True)):
        port = _port(*flags, seed=1 + flags[0])
        out[flags] = (port, *_jax(port))
    return out


def _layer_cases(port):
    """(name, JAX submodule call, port module, input channels, spatial size)."""
    ie = port.ie_net
    cases = [
        ("input_layer", lambda m, a: m.ie_net.input_layer(a), ie.input_layer, 3, 16),
        ("enc2", lambda m, a: m.ie_net.enc2(a, False), ie.enc2, 64, 8),
        ("bottleneck1", lambda m, a: m.ie_net.bottleneck1(a, False), ie.bottleneck[0], 256, 4),
        ("dec2", lambda m, a: m.ie_net.dec2(a, False), ie.dec2, 128, 4),
        ("scale2", lambda m, a: m.scale2(a), port.scale2, 3, 16),
    ]
    if port.use_aspp:
        cases.append(("aspp", lambda m, a: m.ie_net.aspp(a, False), ie.bottleneck[1], 256, 8))
    return cases


@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["post_act", "preact_aspp"])
def test_each_layer_matches_flax_in_bf16(nets, flags):
    """ConvBNReLU (the ASPP's), the residual blocks (post- and pre-
    activation, stride 1 and 2), UpBlock, ASPPModule, the conv and the scale
    tower (max pool, conv + EnhancedFAM) against Flax's, eagerly, on bf16
    inputs (the stem and the tower on the f32 image, which Flax rounds
    itself)."""
    port, model, variables = nets[flags]
    rng = np.random.default_rng(3)
    for name, call, module, cin, size in _layer_cases(port):
        x = (np.abs(rng.standard_normal((2, size, size, cin))) * 0.5).astype(np.float32)
        on_image = name in ("input_layer", "scale2")
        want = model.apply(variables, jnp.asarray(x) if on_image else jnp.asarray(x).astype(jnp.bfloat16), method=call)
        with torch.inference_mode():
            got = module(_nchw(x) if on_image else _nchw(x).to(BF16))
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        want = _np(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=2.0**-7, atol=2.0**-7 * np.abs(want).max(), err_msg=name)


def test_bf16_resize_matches_jax_image_resize():
    """The bf16 bilinear resize of a feature map (the standard forward's
    upsampling of the scale-2/3 towers, the packed one where the fusion does
    not fold): bit-identical to the JAX package's resize_bilinear in bf16."""
    from retinex_tpu.ops.resize import resize_bilinear as jax_resize
    from retinex_tpu_torch.ops.resize import resize_bilinear

    rng = np.random.default_rng(4)
    for shape, size in (((2, 17, 30, 8), (68, 120)), ((1, 16, 30, 4), (67, 120)), ((1, 12, 20, 3), (6, 10))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = jax_resize(jnp.asarray(x).astype(jnp.bfloat16), *size)
        got = resize_bilinear(torch.from_numpy(x).to(BF16), *size)
        assert got.dtype == BF16
        np.testing.assert_array_equal(_np(got), _np(want))


def test_standard_forward_matches_jax(nets):
    port, model, variables = nets[(False, False)]
    x = np.random.default_rng(5).random((2, 32, 64, 3), dtype=np.float32) * 0.6 + 0.05
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    want = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, jnp.asarray(x))
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert [w.dtype for w in want] == [jnp.float32] * 3
    for g, w, tol in zip(got, want, (8e-3, 2.1e-3, 1.9e-3)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=tol)


@pytest.mark.parametrize("h,w", [(32, 64), (40, 56)], ids=["fold_k6", "no_fold_k11"])
def test_packed_forward_matches_jax_packed(nets, h, w):
    """32x64 folds the fusion into K6; 40x56 does not (K11 and the bf16
    resizes), as a 1080-row frame does not."""
    port, model, variables = nets[(False, False)]
    x = np.random.default_rng(7).random((2, h, w, 3), dtype=np.float32) * 0.6 + 0.05
    with torch.inference_mode():
        got = PackedRetinex(port)(torch.from_numpy(x))
    want = jax.jit(JaxPacked(model, variables))(jnp.asarray(x))
    assert [g.dtype for g in got] == [torch.float32, torch.float32, BF16]
    assert [v.dtype for v in want] == [jnp.float32, jnp.float32, jnp.bfloat16]
    for g, w, tol in zip(got, want, (1.1e-2, 1.4e-2, 2.0**-7)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=tol)


def test_bf16_routes_that_are_not_ported_raise(nets, tmp_path):
    """K10 in bf16 (item 3c), bf16 training (item 3b) and training on
    several devices (item 8) are ported: the bf16 dec1-chain forward builds,
    its K10 packed for bf16 (tests/test_torch_dec1_chain_bf16.py holds it to
    the JAX package); so is spatial sharding (item 9), which now raises in no
    mode: the bf16 net's frame split over two CPU shards writes its PNGs."""
    port = nets[(False, False)][0]
    assert PackedRetinex(port, NetCfg(dec1_chain=True)).dec1_packed.dtype == BF16
    photo = REPO / "data" / "convergence" / "lowlight_000.png"
    cli.main(["--mode", "enhance", "--use_amp", "--spatial_shard", "--n_devices", "2", "--input_path", str(photo),
              "--output_dir", str(tmp_path), "--max_size", "256", "--device", "cpu"])
    assert (tmp_path / f"{photo.stem}_enhanced.png").exists()


def test_bf16_illumination_is_quantised_as_the_jax_package_does(tmp_path):
    """A bf16 illumination (the packed forward's): the single-image PNG
    computes clip(v) * 255 in bf16 and truncates (numpy's bf16 in the JAX
    package's ``utils/viz.py``), the batched route floor(v * 255) in bf16,
    the comparison panel the exact f32 values: the bytes equal the JAX
    package's on every bf16 value in [0, 1] and past it. On every such
    value the bf16 product rounds to the byte an f32 product truncates to
    (v has 8 significant bits), so the packed and standard routes' PNGs
    part only where the illumination itself does."""
    from retinex_tpu.utils.viz import create_comparison as jax_comparison
    from retinex_tpu.utils.viz import save_image as jax_save
    from retinex_tpu_torch.infer.enhance import _quant
    from retinex_tpu_torch.utils.viz import create_comparison, save_image

    bits = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16).view(BF16)  # every bf16 in [0, 1.0078]
    v = torch.cat([bits, torch.tensor([-0.25, 1.5], dtype=BF16)])
    side = -(-v.numel() // 128)
    v = torch.nn.functional.pad(v, (0, side * 128 - v.numel())).reshape(side, 128, 1)
    vj = jnp.asarray(_np(v)).astype(jnp.bfloat16)
    save_image(v, str(tmp_path / "port.png"))
    jax_save(vj, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_png(tmp_path / "port.png"), _png(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_png(tmp_path / "port.png")[..., 0], (np.clip(_np(v), 0, 1) * 255).astype(np.uint8)[..., 0])
    want_batched = np.asarray(jnp.clip(jnp.floor(vj * 255.0), 0, 255).astype(jnp.uint8))
    np.testing.assert_array_equal(_quant(v).numpy(), want_batched)
    img = np.full((side, 128, 3), 0.5, np.float32)
    np.testing.assert_array_equal(create_comparison(img, img, v), jax_comparison(img, img, vj))


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs with --use_amp from one .pth, enhance and predict, on one
    in-repo photo at --max_size 64 and on a directory of two 64x96 photos
    at batch 2. Returns (root, {mode: stems})."""
    root = tmp_path_factory.mktemp("amp_cli")
    ckpt = root / "model.pth"
    torch.save({"epoch": 0, "model_state_dict": _port(seed=3).state_dict()}, ckpt)
    photos = root / "photos"
    photos.mkdir()
    for i in (1, 2):
        src = REPO / "data" / "convergence" / f"lowlight_{i:03d}.png"
        Image.open(src).convert("RGB").resize((96, 64)).save(photos / src.name)
    photo = REPO / "data" / "convergence" / "lowlight_000.png"
    for mode in ("predict", "enhance"):
        for inp, size in ((photo, "64"), (photos, "96")):
            args = ["--mode", mode, "--input_path", str(inp), "--max_size", size, "--use_amp", "--batch_size", "2",
                    "--checkpoint", str(ckpt)]
            jax_cli.main([*args, "--output_dir", str(root / f"jax_{mode}")])
            cli.main([*args, "--output_dir", str(root / f"port_{mode}"), "--device", "cpu"])
    return root, [photo.stem, "lowlight_001", "lowlight_002"]


@pytest.mark.parametrize("mode", ["predict", "enhance"])
def test_cli_use_amp_matches_the_jax_cli(cli_runs, mode):
    root, stems = cli_runs
    assert sorted(os.listdir(root / f"port_{mode}")) == sorted(os.listdir(root / f"jax_{mode}"))
    assert len(os.listdir(root / f"port_{mode}")) == 3 * len(stems)
    for stem in stems:
        for kind in KINDS:
            d = np.abs(_png(root / f"port_{mode}" / f"{stem}_{kind}.png") - _png(root / f"jax_{mode}" / f"{stem}_{kind}.png"))
            what = f"{mode} {stem}_{kind}: max {d.max()}, mean {d.mean():.3f}, {(d > 0).mean():.2e} of bytes differ"
            if mode == "enhance" and kind != "illumination":
                assert d.mean() < 0.45, what
            else:
                assert d.max() <= 1 and (d > 0).mean() < 5e-2, what
