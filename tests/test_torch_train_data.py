"""The port's training data against the JAX package's: the loader's batch
order and bytes, the augmentation fed JAX's own draws, the device letterbox
and the learning-rate schedules."""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retinex_tpu.data import augment as jaug
from retinex_tpu.data import dataset as jds
from retinex_tpu.ops import letterbox as jlb
from retinex_tpu.train import schedules as jsch
from retinex_tpu_torch.data import augment as taug
from retinex_tpu_torch.data import dataset as tds
from retinex_tpu_torch.ops import letterbox as tlb
from retinex_tpu_torch.train import schedules as tsch

CONVERGENCE = Path(__file__).resolve().parent.parent / "data" / "convergence"

@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads for the port: the tests run beside other workers,
    and PyTorch's default of one thread per core oversubscribes the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)



@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    """Seven in-repo photos, three of them cropped to other aspect ratios
    (so the letterbox pads), one in a subdirectory (the scan recurses)."""
    d = tmp_path_factory.mktemp("train")
    (d / "sub").mkdir()
    for i in range(7):
        src = CONVERGENCE / f"lowlight_{i:03d}.png"
        dst = d / ("sub" if i == 6 else "") / src.name
        if i in (1, 3, 5):
            with Image.open(src) as im:
                im.convert("RGB").crop((0, 0, 640, 400 - 60 * (i // 2))).save(dst)
        else:
            shutil.copy(src, dst)
    return str(d)


@pytest.fixture(scope="module")
def jax_native_library():
    """The JAX native loader's library, which its training loader takes.
    Each test process builds it on first use (``make -C native``); where
    another process's build is still writing it, its load fails once, so
    wait for the finished file."""
    import time

    import retinex_tpu.data.native_loader as native

    for _ in range(120):
        if native.native_available():
            return
        native._load_failed = False
        time.sleep(1)
    pytest.fail("the JAX native loader's library does not load")


@pytest.mark.parametrize("drop_last", [True, False])
def test_train_loader_batches_equal_jax_over_two_epochs(train_dir, jax_native_library, drop_last):
    """Same seed: the same batches (order and bytes) epoch after epoch. The
    JAX package's loader takes its native decoder, as its trainer does, and
    the port's host path gives that decoder's bytes."""
    kw = dict(batch_size=3, image_size=96, num_workers=2, shuffle=True, drop_last=drop_last, seed=5)
    jl, tl = jds.get_train_loader(train_dir, **kw), tds.get_train_loader(train_dir, **kw)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    assert tl.dataset.image_files == jl.dataset.image_files
    for _epoch in range(2):
        jit = iter(jl)
        assert jit.use_native
        got, want = list(iter(tl)), list(jit)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_prefetch_iterator_closes_on_an_early_break(train_dir):
    tl = tds.get_train_loader(train_dir, batch_size=1, image_size=32, num_workers=1)
    with iter(tl) as it:
        next(it)
    assert not it.thread.is_alive()
    test = tds.get_test_loader(train_dir, max_size=64)
    img, name = next(iter(test))
    assert img.shape[0] == 1 and img.shape[1] % 32 == 0 and name.endswith(".png")


def _jax_draws(key, shape):
    """The draws augment_batch makes from `key` (retinex_tpu/data/augment.py:
    72-95), as torch tensors: the basic ones recomputed from
    jax.random.split(key, 16), the advanced ones from sample_advanced_params
    with its normal noise drawn as the jitted function draws it."""
    b = shape[0]
    keys = jax.random.split(key, 16)
    basic = {
        "hflip": jax.random.uniform(keys[0], (b, 1, 1, 1)).reshape(b) < 0.5,
        "vflip": jax.random.uniform(keys[1], (b, 1, 1, 1)).reshape(b) < 0.5,
        "rot": jax.random.uniform(keys[2], (b,)) < 0.5,
        "k": jax.random.randint(keys[3], (b,), 1, 4),
    }
    adv = dict(jaug.sample_advanced_params(key, b))
    adv["noise"] = jax.jit(lambda k: jax.random.normal(k, shape))(adv.pop("noise_key"))
    to_t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # noqa: E731
    return to_t(basic), to_t(adv)


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (3, 24, 40, 3)])
def test_augment_apply_with_jax_draws_equals_jax(shape):
    """u8 in: the basic half (flips, quarter turns, and u8 * f32(1/255), the
    product the jitted u8 / 255.0 compiles to) equals JAX's output exactly.
    The advanced half (gamma, contrast, brightness, noise, saturation, hue)
    is within one f32 ulp of 1.0 on a few percent of the values: XLA's
    program reassociates its products, sums the per-sample mean in its own
    order and fuses erf_inv into the noise, none of which the port copies."""
    u8 = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    basic, adv = _jax_draws(key, shape)
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(u8), basic=True, advanced=False))
    got = taug.apply_augment(torch.from_numpy(u8), basic, None).numpy()
    np.testing.assert_array_equal(got, want)
    # The division alone: 126 of the 256 bytes round otherwise under IEEE division.
    q = taug.apply_augment(torch.arange(256, dtype=torch.uint8).view(1, 16, 16, 1)).numpy().ravel()
    assert (q == np.arange(256, dtype=np.float32) * np.float32(1 / 255)).all()
    assert int((q != np.arange(256, dtype=np.float32) / np.float32(255)).sum()) == 126
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(u8), basic=True, advanced=True))
    got = taug.apply_augment(torch.from_numpy(u8), basic, adv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)
    assert (got != want).mean() < 0.2


def test_port_draws_have_the_jax_rates():
    gen = torch.Generator().manual_seed(0)
    n = 8192
    adv = taug.draw_advanced((n, 2, 2, 3), gen)
    for gate, p in taug.ADVANCED_GATES.items():
        assert abs(float(adv[gate].mean()) - p) < 0.03, gate
    for name, (lo, hi) in taug.ADVANCED_RANGES.items():
        v = adv[name].ravel()
        assert float(v.min()) >= lo and float(v.max()) <= hi and float(v.max() - v.min()) > 0.95 * (hi - lo), name
        on = adv[{"gamma": "g_on", "contrast": "c_on", "brightness": "br_on", "sigma": "n_on",
                  "saturation": "s_on", "hue": "h_on"}[name]].ravel() > 0.5
        mid = (lo + hi) / 2
        assert 0.45 < float((v[on] > mid).float().mean()) < 0.55, f"{name} is correlated with its gate"
    assert abs(float(adv["noise"].std()) - 1.0) < 0.02
    basic = taug.draw_basic(n, gen)
    for k in ("hflip", "vflip", "rot"):
        assert abs(float(basic[k].float().mean()) - 0.5) < 0.03, k
    counts = torch.bincount(basic["k"], minlength=4)
    assert counts[0] == 0 and all(abs(int(c) / n - 1 / 3) < 0.03 for c in counts[1:])
    x = torch.rand((8, 16, 16, 3), generator=gen)
    out = taug.augment_batch(x, gen, basic=True, advanced=False)
    np.testing.assert_array_equal(np.sort(out.reshape(8, -1).numpy(), 1), np.sort(x.reshape(8, -1).numpy(), 1))
    out = taug.augment_batch(x, gen, basic=True, advanced=True)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


@pytest.mark.parametrize("quantize_u8", [True, False])
@pytest.mark.parametrize("hw,target", [((40, 50), 64), ((64, 48), 64), ((32, 32), 32)])
def test_device_letterbox_matches_jax(quantize_u8, hw, target):
    """Float output within 1e-6 of JAX's; with the u8 round trip, a resized
    value at a .5 tie of the 0-255 grid may round the other way (the two
    resizes sum in other orders): at most one level, on under 1e-3 of the
    values (tests/test_clahe_gather.py's bound for such ties)."""
    x = np.random.default_rng(hw[0]).random((2, *hw, 3), dtype=np.float32)
    plan_j = jlb.plan_letterbox(*hw, target, auto=False)
    plan_t = tlb.plan_letterbox(*hw, target, auto=False)
    want = np.asarray(jlb.letterbox(jnp.asarray(x), plan_j, quantize_u8=quantize_u8))
    got = tlb.letterbox(torch.from_numpy(x), plan_t, quantize_u8=quantize_u8).numpy()
    assert got.shape == want.shape == (2, target, target, 3)
    d = np.abs(got - want)
    if quantize_u8:
        assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-6).mean() < 1e-3, (d.max(), (d > 1e-6).mean())
        np.testing.assert_array_equal(np.round(got * 255) / 255, got)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = tlb.letterbox(torch.from_numpy(x[0]), plan_t, quantize_u8=quantize_u8).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize(
    "name,args",
    [
        ("step_decay", (1e-4,)),
        ("step_decay", (3e-4, 7, 0.3)),
        ("step_decay", (2e-3, 10, 0.1)),
        ("cosine_warm_restarts", (1e-4,)),
        ("cosine_warm_restarts", (2e-3,)),
        ("cosine_warm_restarts", (1e-4, 10, 1)),
    ],
)
def test_schedules_equal_jax_f32_over_200_epochs(name, args):
    """Each schedule as the trainer builds it (the cosine one with its
    defaults, t_0 10 and t_mult 2; t_mult 1 too), the f32 value JAX's jitted
    schedule gives, exactly, for every epoch 0-200."""
    jfn = jax.jit(getattr(jsch, name)(*args))
    tfn = getattr(tsch, name)(*args)
    want = np.asarray([jfn(e) for e in range(201)], np.float32)
    got = np.asarray([tfn(e) for e in range(201)], np.float32)
    np.testing.assert_array_equal(got, want)
