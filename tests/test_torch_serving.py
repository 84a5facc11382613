"""The port's serving artifacts (retinex_tpu_torch/infer/serving.py) against
the JAX package's (retinex_tpu/infer/serving.py) and against the port's own
eager pipeline, on the CPU at a 64x96 canvas.

Same weights on both sides: the port's seeded untrained net, carried to
Flax by ``models/convert.py::state_dict_to_variables`` (Flax's model.init
alone takes ~20 s here). One export per pipeline and package, shared by the
module. Each artifact serves seeded u8 batches of 1 and 3.

- Against the JAX artifact: the enhance pipeline within the bounds of
  tests/test_torch_batch_enhance.py's net test (enhanced under 1e-3 of the
  bytes off by more than 0.5, and at most 2 levels at every pixel whose
  Lab bytes the two pipelines agree on; illumination at most 1 level). Where
  the port's Lab bytes (K1's exact cube root) part from the JAX XLA route's
  by one (ROADMAP "Expected divergences", F5; or a net ulp at a .5 tie,
  F2), the a or b byte passes to RGB by about three levels: seed 11 has
  one such pixel, 3 levels off. Predict and msr at most 1 level on under
  1e-3 of the bytes (tests/test_torch_predict.py); clahe and clahe_luma at
  hist_subsample 1 and 2 equal, image by image, to the JAX artifact's bytes
  or to the JAX single-image route's (the rule of test_torch_batch_enhance.py: the JAX
  package's two routes part at exact rounding ties).
- Against the port: every artifact equals ``make_batch_pipeline``'s bytes
  (the standard net for enhance; the quantised forward for predict).
- As tests/test_serving.py: the file round trip, a wrong canvas raising,
  clahe_luma at hist_subsample 2 differing from 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinex_tpu.infer import serving as jax_serving
from retinex_tpu.infer.enhance import _classical_enhance as jax_classical
from retinex_tpu.models import MultiScaleUPRetinex as JaxNet
from retinex_tpu.ops.colorspace import rgb_to_lab_u8 as jax_rgb_to_lab_u8
from retinex_tpu_torch.cli import init_untrained
from retinex_tpu_torch.infer import serving
from retinex_tpu_torch.infer.enhance import _quant, make_batch_pipeline
from retinex_tpu_torch.models.convert import state_dict_to_variables
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.ops.clahe_gather import lab_fwd_f32_nhwc_plain

H, W = 64, 96
BATCHES = (1, 3)
NETS = ("enhance", "predict")
# (mode, hist_subsample) of the classical artifacts.
CLASSICAL = [("clahe", 1), ("clahe", 2), ("clahe_luma", 1), ("clahe_luma", 2), ("ssr", 1), ("msr", 1), ("msrcr", 1)]
CLAHE = [c for c in CLASSICAL if c[0].startswith("clahe")]


@pytest.fixture(scope="module")
def port_net():
    return init_untrained(MultiScaleUPRetinex(use_preact=False, use_aspp=False), 0).eval()


@pytest.fixture(scope="module")
def jax_net(port_net):
    return JaxNet(use_preact=False, use_aspp=False), state_dict_to_variables(port_net.state_dict(), use_aspp=False)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    return {b: rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8) for b in BATCHES}


class _Artifacts:
    """Each artifact exported once per module, on first use."""

    def __init__(self, port_net, jax_net):
        self.port_net, self.jax_net = port_net, jax_net
        self.blobs: dict = {}

    def port(self, key) -> bytes:
        if ("port", key) not in self.blobs:
            if key in NETS:
                blob = serving.export_enhancer(self.port_net, H, W, device="cpu", pipeline=key)
            else:
                blob = serving.export_classical(key[0], H, W, device="cpu", hist_subsample=key[1])
            self.blobs["port", key] = blob
        return self.blobs["port", key]

    def jax(self, key) -> bytes:
        if ("jax", key) not in self.blobs:
            if key in NETS:
                model, variables = self.jax_net
                blob = jax_serving.export_enhancer(model, variables, H, W, pipeline=key)
            else:
                blob = jax_serving.export_classical(key[0], H, W, hist_subsample=key[1])
            self.blobs["jax", key] = blob
        return self.blobs["jax", key]


@pytest.fixture(scope="module")
def artifacts(port_net, jax_net):
    return _Artifacts(port_net, jax_net)


def _serve_port(blob, x: np.ndarray):
    out = serving.load_enhancer(blob)(torch.from_numpy(x))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _serve_jax(blob, x: np.ndarray):
    out = jax_serving.load_enhancer(blob)(x)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _levels(a, b) -> np.ndarray:
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def _lab_parts(port_net, jax_net, x: np.ndarray) -> np.ndarray:
    """[B,H,W] bool: the pixels whose Lab bytes, the input of the adaptive
    Lab-CLAHE, differ between the port's pipeline (K1's plain version on the
    port's net output) and the JAX artifact's (the XLA route's rgb_to_lab_u8
    on the JAX net's output, jitted as the artifact is)."""
    model, variables = jax_net
    with torch.inference_mode():
        enh = port_net(torch.from_numpy(x).to(torch.float32) / 255.0)[0]
    port_lab = lab_fwd_f32_nhwc_plain(torch.clamp(enh, 0.0, 1.0)).permute(0, 2, 3, 1).numpy()

    def jax_lab(b):
        e = jnp.clip(model.apply(variables, b.astype(jnp.float32) / 255.0, train=False)[0], 0.0, 1.0)
        return jnp.clip(jnp.round(jax_rgb_to_lab_u8(jnp.round(e * 255.0) / 255.0)), 0, 255).astype(jnp.uint8)

    return np.any(port_lab != np.asarray(jax.jit(jax_lab)(x)), axis=-1)


@pytest.mark.parametrize("batch", BATCHES)
def test_enhance_artifact_matches_jax(artifacts, port_net, jax_net, batches, batch):
    x = batches[batch]
    enh, illu = _serve_port(artifacts.port("enhance"), x)
    want_enh, want_illu = _serve_jax(artifacts.jax("enhance"), x)
    assert enh.shape == want_enh.shape == x.shape and enh.dtype == np.uint8
    d = _levels(enh, want_enh)
    parts = _lab_parts(port_net, jax_net, x)
    assert (d > 0.5).mean() < 1e-3, f"enhanced: {(d > 0.5).mean():.2e} of the bytes off"
    assert parts.mean() < 1e-3, f"the Lab bytes part at {parts.mean():.2e} of the pixels"
    kept = d[~parts]
    assert kept.max() <= 2, f"enhanced: max {kept.max()} where the Lab bytes agree (max {d.max()} overall)"
    d = _levels(illu, want_illu)
    assert illu.shape == want_illu.shape and d.max() <= 1, f"illumination: max {d.max()}"


def _assert_within_a_level(got, want, what: str) -> None:
    assert got.shape == want.shape and got.dtype == np.uint8, (what, got.shape, want.shape, got.dtype)
    d = _levels(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, f"{what}: max {d.max()}, {(d > 0).mean():.2e} off"


@pytest.mark.parametrize("batch", BATCHES)
def test_predict_artifact_matches_jax(artifacts, batches, batch):
    x = batches[batch]
    got, want = _serve_port(artifacts.port("predict"), x), _serve_jax(artifacts.jax("predict"), x)
    for name, g, w in zip(("enhanced", "illumination"), got, want):
        _assert_within_a_level(g, w, name)


@pytest.mark.parametrize("batch", BATCHES)
def test_msr_artifact_matches_jax(artifacts, batches, batch):
    x = batches[batch]
    _assert_within_a_level(_serve_port(artifacts.port(("msr", 1)), x), _serve_jax(artifacts.jax(("msr", 1)), x), "msr")


@pytest.mark.parametrize("mode,s", CLAHE)
def test_clahe_artifacts_match_jax(artifacts, batches, mode, s):
    for x in batches.values():
        got, want = _serve_port(artifacts.port((mode, s)), x), _serve_jax(artifacts.jax((mode, s)), x)
        assert got.shape == want.shape == x.shape and got.dtype == np.uint8
        for i in range(x.shape[0]):
            if np.array_equal(got[i], want[i]):
                continue
            img = jnp.asarray(x[i].astype(np.float32) / 255.0)
            single = np.asarray(jax_classical(img, mode, None, hist_subsample=s))
            single = (single * 255).astype(np.uint8)  # the JAX route's save_image truncation
            assert np.array_equal(got[i], single), (
                f"image {i}: max diff {_levels(got[i], want[i]).max()} from the JAX artifact, "
                f"{_levels(got[i], single).max()} from the JAX single-image route"
            )


@pytest.mark.parametrize("key", [*NETS, *CLASSICAL], ids=str)
def test_artifact_matches_the_eager_pipeline(artifacts, port_net, batches, key):
    """The served bytes are the eager pipeline's, byte for byte."""

    def forward(b):
        return port_net(b)

    for x in batches.values():
        xt = torch.from_numpy(x)
        got = _serve_port(artifacts.port(key), x)
        with torch.inference_mode():
            if key == "predict":
                enh, _refl, illu = port_net(xt.to(torch.float32) / 255.0)
                want = (_quant(enh).numpy(), _quant(illu).numpy())
            elif key == "enhance":
                want = tuple(o.numpy() for o in make_batch_pipeline(forward)(xt))
            else:
                want = make_batch_pipeline(None, key[0], hist_subsample=key[1])(xt)[0].numpy()
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["enhance", ("clahe", 1)], ids=str)
def test_a_ragged_canvas_serves_any_batch(port_net, key):
    """At 72x104 (not cell-divisible) the CPU's plain Lab-CLAHE route,
    ``clahe_u8``, is traced into the artifact: it serves batches of 1 and 3
    from an example of 2, with the eager pipeline's bytes, and the eager
    pipeline afterwards still computes on real tensors (no traced tensor
    left in a cache)."""
    h, w = 72, 104
    if key == "enhance":
        served = serving.load_enhancer(serving.export_enhancer(port_net, h, w, device="cpu"))
        eager = make_batch_pipeline(lambda b: port_net(b))
    else:
        served = serving.load_enhancer(serving.export_classical("clahe", h, w, device="cpu"))
        eager = make_batch_pipeline(None, "clahe")
    rng = np.random.default_rng(12)
    for b in BATCHES:
        x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
        got = served(x)
        with torch.inference_mode():
            want = [o for o in eager(x) if o is not None]
        for g, wnt in zip(got if isinstance(got, tuple) else (got,), want):
            assert type(wnt) is torch.Tensor
            assert torch.equal(g, wnt)


def test_export_round_trips_through_a_file(artifacts, batches, tmp_path):
    path = tmp_path / "clahe_64x96.pt2"
    blob = serving.export_classical("clahe", H, W, path=str(path), device="cpu")
    assert path.read_bytes() == blob
    x = batches[3]
    np.testing.assert_array_equal(_serve_port(str(path), x), _serve_port(artifacts.port(("clahe", 1)), x))


@pytest.mark.parametrize("key", ["predict", ("clahe", 1)], ids=str)
def test_wrong_canvas_raises(artifacts, key):
    served = serving.load_enhancer(artifacts.port(key))
    with pytest.raises(Exception):
        served(torch.zeros((1, 32, W, 3), dtype=torch.uint8))
    with pytest.raises(Exception):
        served(torch.zeros((2, H, W + 16, 3), dtype=torch.uint8))


def test_luma_hist_subsample_changes_the_output(artifacts, batches):
    x = batches[1]
    s1, s2 = _serve_port(artifacts.port(("clahe_luma", 1)), x), _serve_port(artifacts.port(("clahe_luma", 2)), x)
    assert _levels(s1, s2).max() > 0


def test_unknown_pipeline_and_mode_raise(port_net):
    with pytest.raises(ValueError, match="pipeline"):
        serving.make_serving_fn(port_net, pipeline="train")
    with pytest.raises(ValueError, match="mode"):
        serving.export_classical("retinex", H, W, device="cpu")
