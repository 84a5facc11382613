#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (retinex_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; no phase is skipped):

1. The card's name and power limit; build the CUDA kernels from every
   ``retinex_tpu_torch/csrc/*.cu`` (one nvcc per source, all at once,
   printing the seconds and the ptxas report).
2. K1-K3: on a seeded u8 frame at 1088x1920 (the main path's shape) and at
   2160x3840 (a cell width of 240 columns), each kernel is held to its plain
   PyTorch version on the card: K1 (lab_fwd_u8) and K3 (clahe_apply_u8) within
   1 level on under 1e-4 of the bytes, K2 (clahe_tables) identical. Median
   kernel times over 25 launches (CUDA events) at both shapes.
3. K4-K6 and K11: at the packed FAM shapes of the letterboxed frame,
   [1,544,960,128] (scale 1) and [1,136,240,128] (scale 2), at those of the
   unpadded 1080-row frame, [1,540,960,128] and [1,135,240,128], and at a
   ragged [2,37,53,128], seeded inputs x >= 0 and weights scaled as
   tests/test_fused_blocks.py scales them: fam_conv_fused within 2e-4,
   fam_tail_stats within 1e-5, fam_tail_apply_g1 within 1e-4, fam_tail_apply
   within 1e-5 of the plain version (TF32 off). Median times over 25
   launches, beside the plain version's and the bound: K4-K6 at the
   letterboxed shapes, K11 (which only the unpadded frame runs) at the
   unpadded ones.
4. The standard route through the CLI, ``--mode enhance --max_size 1920
   --no-packed_inference``, on a 1920x1080 PNG upscaled from
   ``data/convergence/lowlight_000.png``, untrained weights from seed 0: the
   three PNGs, K1-K3 launched once each, the enhanced image held to the
   port's CPU run (max 3 levels, mean under 0.05 levels).
5. The default route through the CLI (packed forward), same photo: the
   three PNGs, K1-K3 launched once and K4-K6 twice each. The packed forward
   is held to the standard forward on the card (same weights and input:
   illumination 2e-5, reflectance and enhanced 2e-3, as
   tests/test_packed_inference.py), and the packed route on the card to the
   port's CPU packed route at ``--max_size 512`` (as in phase 4).
6. The headline command with no flags, ``--mode enhance --input_path
   photo``, on the same photo: no letterbox, so the frame stays 1080x1920,
   whose fusion does not fold (1080 is not a multiple of 16). The three
   PNGs; K4, K5 and K11 launched twice each, K6 never, K1-K3 never (1080 is
   not a multiple of 16 either, so Lab-CLAHE takes its plain route, as the
   JAX package's does at such shapes). The packed forward is held to the
   standard one on the card at 1080x1920, and the card's flagless run to the
   port's CPU run on a 264x480 frame (also unfolded).
7. Warm times, batch 1: the standard and the packed net, Lab-CLAHE, end to
   end per route at 1088x1920, the same for the flagless route at
   1080x1920, and the FAM kernels' device ms per image.
8. Device time by kernel (torch.profiler) over warm forwards of each route
   at 1088x1920, and the device's busy share of the forwards' wall time.

The last lines are a ``{"kernels": [...]}`` JSON line (``launches`` summed
over the default route's two 1080p CLI runs, phases 5 and 6, each counted
from zero; ``ms``, ``plain_ms`` and ``bound_ms`` per image, i.e. summed over
the kernel's two launches), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# H100 SXM: HBM bandwidth and the f32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per pixel, counted from csrc/clahe_lab.cu: K1 9 mul + 6 add +
# 2 div (matrix), 3 f()s at 3 each, 9 for L/a/b, 9 for 3 round/clips; K3
# 10 (blend) + 3 (round/clip) + 9 (fy, fx, fz) + 11 (f^-1, X, Z) + 15
# (matrix) + 15 (3 gammas) + 12 (3 clip/scale/round). K2: one atomic per
# sampled pixel and ~20 per table entry.
K1_OPS_PER_PX = 44
K3_OPS_PER_PX = 75
K2_OPS_PER_ENTRY = 20
# K5 per packed pixel: 128 multiplies by ca, 4 x 31 adds, 4 x 31 maxima,
# 4 mean scalings.
K5_OPS_PER_PX = 128 + 4 * 31 + 4 * 31 + 4
REPLACES = {
    "lab_fwd_u8": "retinex_tpu/ops/clahe_gather.py:874",
    "clahe_tables": "retinex_tpu/ops/clahe_gather.py:648",
    "clahe_apply_u8": "retinex_tpu/ops/clahe_gather.py:931",
    "fam_conv_fused": "retinex_tpu/ops/fused_blocks.py:395",
    "fam_tail_stats": "retinex_tpu/ops/fused_blocks.py:321",
    "fam_tail_apply_g1": "retinex_tpu/ops/fused_blocks.py:517",
    "fam_tail_apply": "retinex_tpu/ops/fused_blocks.py:338",
}
SOURCES = {
    "lab_fwd_u8": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_tables": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "clahe_apply_u8": "retinex_tpu_torch/csrc/clahe_lab.cu",
    "fam_conv_fused": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_stats": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply_g1": "retinex_tpu_torch/csrc/fam_fused.cu",
    "fam_tail_apply": "retinex_tpu_torch/csrc/fam_fused.cu",
}
# The packed FAM shapes (scale 1, scale 2) of the letterboxed 1088x1920 frame
# and of the unpadded 1080x1920 one.
FAM_SHAPES = ((1, 544, 960, 128), (1, 136, 240, 128))
FAM_SHAPES_1080 = ((1, 540, 960, 128), (1, 135, 240, 128))
FAM_RAGGED = (2, 37, 53, 128)
FAM_TOL = {"fam_conv_fused": 2e-4, "fam_tail_stats": 1e-5, "fam_tail_apply_g1": 1e-4, "fam_tail_apply": 1e-5}
FAM_KERNELS = tuple(FAM_TOL)
# tests/test_packed_inference.py:40-42.
PACKED_TOL = {"enhanced": 2e-3, "reflectance": 2e-3, "illumination": 2e-5}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int = 25) -> float:
    """Median device ms of one call of fn over n calls. A sleep kernel
    queued first keeps the device busy while the host enqueues all n calls,
    so each event interval holds device time only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(n):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(n))


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def u8_diff(torch, a, b) -> tuple[int, float]:
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return int(d.max()), float((d > 0).float().mean())


def clahe_kernel_phase(torch, cg, h: int, w: int, seed: int) -> dict:
    """Hold K1-K3 to their plain versions at h x w; return per-kernel records."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rgb = torch.randint(0, 256, (1, 3, h, w), dtype=torch.uint8, device="cuda", generator=g)
    tiles = 8
    b, n_px = 1, h * w
    n_tiles = tiles * tiles

    lab = cg.lab_fwd_u8(rgb)
    lab_p = cg.lab_fwd_u8_plain(rgb)
    torch.cuda.synchronize()
    k1_max, k1_frac = u8_diff(torch, lab, lab_p)
    print(f"  {h}x{w} K1 lab_fwd_u8: max {k1_max} level(s), {k1_frac:.2e} of bytes differ")
    if k1_max > 1 or k1_frac >= 1e-4:
        raise AssertionError(f"K1 disagrees with its plain version at {h}x{w}")

    for s in (1, 2):
        luts = cg.clahe_tables(lab, hist_subsample=s)
        luts_p = cg.clahe_tables_plain(lab, hist_subsample=s)
        torch.cuda.synchronize()
        if not torch.equal(luts, luts_p):
            raise AssertionError(f"K2 tables differ from the plain version at {h}x{w}, hist_subsample={s}")
        print(f"  {h}x{w} K2 clahe_tables (hist_subsample={s}): identical")
    luts = cg.clahe_tables(lab)

    out = cg.clahe_apply_u8(lab, luts)
    out_p = cg.clahe_apply_u8_plain(lab, luts)
    torch.cuda.synchronize()
    k3_max, k3_frac = u8_diff(torch, out, out_p)
    print(f"  {h}x{w} K3 clahe_apply_u8: max {k3_max} level(s), {k3_frac:.2e} of bytes differ")
    if k3_max > 1 or k3_frac >= 1e-4:
        raise AssertionError(f"K3 disagrees with its plain version at {h}x{w}")

    table_bytes = b * n_tiles * 256
    recs = {
        "lab_fwd_u8": dict(
            max_abs_err=k1_max,
            ms=time_ms(torch, lambda: cg.lab_fwd_u8(rgb)),
            plain_ms=time_ms(torch, lambda: cg.lab_fwd_u8_plain(rgb), n=5),
            bound=bound(6 * b * n_px + 256 * 4, K1_OPS_PER_PX * b * n_px),
        ),
        "clahe_tables": dict(
            max_abs_err=0,
            ms=time_ms(torch, lambda: cg.clahe_tables(lab)),
            plain_ms=time_ms(torch, lambda: cg.clahe_tables_plain(lab), n=5),
            bound=bound(b * n_px + table_bytes, b * n_px + K2_OPS_PER_ENTRY * table_bytes),
        ),
        "clahe_apply_u8": dict(
            max_abs_err=k3_max,
            ms=time_ms(torch, lambda: cg.clahe_apply_u8(lab, luts)),
            plain_ms=time_ms(torch, lambda: cg.clahe_apply_u8_plain(lab, luts), n=5),
            bound=bound(6 * b * n_px + table_bytes, K3_OPS_PER_PX * b * n_px),
        ),
    }
    for name, r in recs.items():
        print(
            f"  {h}x{w} {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]})"
        )
    return recs


def fam_inputs(torch, shape, seed: int) -> dict:
    """Seeded K4-K6 inputs on the card, scaled as tests/test_fused_blocks.py
    scales them (x >= 0, the FAM input being post-ReLU)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape

    def n(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    x = n(b, h, w, c, scale=0.3).abs()
    w1, w2 = n(c, c, scale=0.05), n(c, c, scale=0.05)
    wf = [n(c, c, scale=0.05) for _ in range(4)]
    k32, k42 = n(3, 3, c, c, scale=0.05), n(3, 3, c, c, scale=0.05)
    return dict(
        x=x,
        ka=(w1 @ wf[0]).contiguous(),
        kb=(w2 @ wf[1]).contiguous(),
        k1=n(3, 3, c, 2 * c, scale=0.05),
        b1=n(2 * c, scale=0.1),
        k32=torch.einsum("uvio,op->uvip", k32, wf[2]).contiguous(),
        k42=torch.einsum("uvio,op->uvip", k42, wf[3]).contiguous(),
        bias_total=n(c, scale=0.1),
        ca_vec=torch.sigmoid(n(b, c // 4)).repeat(1, 4).contiguous(),
        sa=torch.sigmoid(n(b, h, w, 4)),
        wg=n(c, c, scale=0.05),
    )


def fam_kernel_phase(torch, fb, shape, seed: int, timed: tuple = ()) -> dict:
    """Hold K4-K6 and K11 to their plain versions at `shape`; return records
    (median ms over 25 launches, plain ms, bound) of the kernels in `timed`."""
    d = fam_inputs(torch, shape, seed)
    conv_args = [d[k] for k in ("x", "ka", "kb", "k1", "b1", "k32", "k42", "bias_total")]
    calls = {
        "fam_conv_fused": (fb.fam_conv_fused, fb.fam_conv_fused_plain, conv_args),
        "fam_tail_stats": (fb.fam_tail_stats, fb.fam_tail_stats_plain, [d["x"], d["ca_vec"]]),
        "fam_tail_apply_g1": (
            fb.fam_tail_apply_g1, fb.fam_tail_apply_g1_plain, [d["x"], d["ca_vec"], d["sa"], d["wg"]],
        ),
        "fam_tail_apply": (fb.fam_tail_apply, fb.fam_tail_apply_plain, [d["x"], d["ca_vec"], d["sa"]]),
    }
    b, h, w, c = shape
    n_px = b * h * w
    weight_bytes = 4 * (2 * c * c + 9 * c * 2 * c + 2 * c + 2 * 9 * c * c + c)
    bounds = {
        "fam_conv_fused": bound(2 * 4 * n_px * c + weight_bytes, 2 * n_px * (9 * c * 512 + 2 * c * c)),
        "fam_tail_stats": bound(4 * n_px * c + 4 * b * c + 4 * n_px * 8, K5_OPS_PER_PX * n_px),
        "fam_tail_apply_g1": bound(
            4 * n_px * (c + 4 + c) + 4 * (b * c + c * c), n_px * (2 * c + 2 * c * c)
        ),
        "fam_tail_apply": bound(4 * n_px * (c + 4 + c) + 4 * b * c, n_px * 2 * c),
    }
    recs = {}
    for name, (kernel, plain, args) in calls.items():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not np.isfinite(err) or err > FAM_TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: max |diff| {err:.3e}")
        line = f"  {list(shape)} {name}: max |diff| {err:.3e} (tolerance {FAM_TOL[name]:g})"
        if name in timed:
            ms = time_ms(torch, lambda: kernel(*args))
            plain_ms = time_ms(torch, lambda: plain(*args), n=5)
            recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bounds[name])
            line += (
                f"; {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bounds[name][0]:.4f} ms by "
                f"{bounds[name][1]}), launches per image 2"
            )
        print(line)
    return recs


def run_cli(torch, modules, args) -> tuple[dict[str, int], float]:
    """Drive the CLI once with every launch count at 0 just before; return
    the counts just after and the seconds."""
    from retinex_tpu_torch import cli

    for m in modules:
        m.reset_launches()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {k: v for m in modules for k, v in m.LAUNCHES.items()}, seconds


def check_pngs(out_dir: Path, stem: str, shape: tuple) -> np.ndarray:
    from PIL import Image

    pngs = [out_dir / f"{stem}_{k}.png" for k in ("enhanced", "illumination", "comparison")]
    for p in pngs:
        if not p.is_file():
            raise AssertionError(f"missing output {p}")
    got = np.asarray(Image.open(pngs[0]).convert("RGB"))
    if got.shape != shape:
        raise AssertionError(f"enhanced PNG has shape {got.shape}, expected {shape}")
    return got


def hold_to_cpu(torch, got: np.ndarray, photo: Path, max_size: int | None, packed: bool) -> None:
    """The card's enhanced PNG against the port's CPU run on the same
    (seeded) weights, plain versions throughout."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image

    cpu_apply = cli.build_apply_fn(Config(mode="enhance", packed_inference=packed, device="cpu"), torch.device("cpu"))
    t0 = time.perf_counter()
    enh_cpu, _, _ = enhance_single_image(
        cpu_apply, str(photo), "", max_size=max_size, save_outputs=False, device="cpu"
    )
    cpu_s = time.perf_counter() - t0
    if not np.isfinite(enh_cpu.numpy()).all():
        raise AssertionError("non-finite values in the CPU run")
    want = (np.clip(enh_cpu.numpy(), 0.0, 1.0) * 255).astype(np.uint8)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    route = "packed" if packed else "standard"
    size = "with no --max_size" if max_size is None else f"at --max_size {max_size}"
    print(
        f"  {route} route {size}, card vs the CPU run ({cpu_s:.1f} s): max {int(d.max())} "
        f"levels, mean {float(d.mean()):.5f} levels, {float((d > 0).mean()):.2e} of bytes differ"
    )
    if d.max() > 3 or d.mean() >= 0.05:
        raise AssertionError(f"the card's enhanced output ({route} route) disagrees with the CPU run")


def standard_phase(torch, modules, photo: Path, workdir: Path) -> dict[str, int]:
    """Phase 4: the --no-packed_inference route through the CLI."""
    out_dir = workdir / "out_standard"
    args = [
        "--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir),
        "--max_size", "1920", "--no-packed_inference", "--device", "cuda",
    ]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    for name in ("lab_fwd_u8", "clahe_tables", "clahe_apply_u8"):
        if launches[name] != 1:
            raise AssertionError(f"the standard route launched {name} {launches[name]} times, expected 1")
    for name in FAM_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"the standard route launched {name}")
    got = check_pngs(out_dir, photo.stem, (1088, 1920, 3))
    hold_to_cpu(torch, got, photo, 1920, packed=False)
    return launches


def packed_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> dict[str, int]:
    """Phase 5: the default (packed) route through the CLI."""
    out_dir = workdir / "out_packed"
    args = [
        "--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir),
        "--max_size", "1920", "--device", "cuda",
    ]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    want = {"lab_fwd_u8": 1, "clahe_tables": 1, "clahe_apply_u8": 1,
            "fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": 2, "fam_tail_apply": 0}
    if launches != want:
        raise AssertionError(f"the default route launched {launches}, expected {want}")
    check_pngs(out_dir, photo.stem, (1088, 1920, 3))

    hold_packed_to_standard(torch, photo, 1920)

    # The card against the port's CPU packed route, at a small letterbox.
    out_small = workdir / "out_packed_512"
    launches_small, _ = run_cli(torch, modules, [
        "--mode", "enhance", "--input_path", str(small), "--output_dir", str(out_small),
        "--max_size", "512", "--device", "cuda",
    ])
    if any(launches_small[k] != 2 for k in ("fam_conv_fused", "fam_tail_stats", "fam_tail_apply_g1")):
        raise AssertionError(f"the default route at --max_size 512 launched {launches_small}")
    got = check_pngs(out_small, small.stem, (288, 512, 3))
    hold_to_cpu(torch, got, small, 512, packed=True)
    return launches


def hold_packed_to_standard(torch, photo: Path, max_size: int | None) -> None:
    """The packed forward against the standard one, both on the card, on the
    CLI's input for `max_size`."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image

    img, _ = load_image(str(photo), max_size)
    x = torch.from_numpy(img).to("cuda")[None]
    std = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))(x)
    pk = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))(x)
    torch.cuda.synchronize()
    for (name, tol), a, b in zip(PACKED_TOL.items(), pk, std):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"packed {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}, or non-finite")
        err = float((a - b).abs().max())
        print(f"  packed vs standard forward on the card, {name} {tuple(a.shape)}: max |diff| {err:.3e} (tolerance {tol:g})")
        if err > tol:
            raise AssertionError(f"the packed forward's {name} disagrees with the standard forward")


def flagless_phase(torch, modules, photo: Path, small: Path, workdir: Path) -> dict[str, int]:
    """Phase 6: the headline command with no flags (no letterbox)."""
    want = {"lab_fwd_u8": 0, "clahe_tables": 0, "clahe_apply_u8": 0,
            "fam_conv_fused": 2, "fam_tail_stats": 2, "fam_tail_apply_g1": 0, "fam_tail_apply": 2}
    out_dir = workdir / "out_flagless"
    args = ["--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir), "--device", "cuda"]
    launches, cold_s = run_cli(torch, modules, args)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    if launches != want:
        raise AssertionError(f"the flagless route launched {launches}, expected {want}")
    check_pngs(out_dir, photo.stem, (1080, 1920, 3))
    hold_packed_to_standard(torch, photo, None)

    # The card against the port's CPU run, on a small frame that does not fold.
    out_small = workdir / "out_flagless_small"
    launches_small, _ = run_cli(torch, modules, [
        "--mode", "enhance", "--input_path", str(small), "--output_dir", str(out_small), "--device", "cuda",
    ])
    if launches_small != want:
        raise AssertionError(f"the flagless route at 264x480 launched {launches_small}, expected {want}")
    got = check_pngs(out_small, small.stem, (264, 480, 3))
    hold_to_cpu(torch, got, small, None, packed=True)
    return launches


def warm_phase(torch, photo: Path, workdir: Path) -> dict[str, dict[str, float]]:
    """Phase 7: warm per-image times of the standard and the packed route at
    --max_size 1920 and of the flagless route, in turns."""
    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    standard = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))
    packed = cli.build_apply_fn(Config(mode="enhance"), torch.device("cuda"))
    routes = {  # name: (apply, --max_size)
        "standard at 1088x1920": (standard, 1920),
        "packed at 1088x1920": (packed, 1920),
        "flagless packed at 1080x1920": (packed, None),
    }
    imgs = {m: load_image(str(photo), m)[0] for m in (1920, None)}
    names = list(routes)
    times = {r: {"net": [], "clahe": [], "e2e": []} for r in routes}
    for i in range(6):
        for route in names[i % 3:] + names[: i % 3]:
            fn, max_size = routes[route]
            x = torch.from_numpy(imgs[max_size]).to("cuda")[None]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh, _, _ = fn(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clahe_lab_rgb(torch.clamp(enh, 0.0, 1.0))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enhance_single_image(fn, str(photo), str(workdir / f"out_warm_{i}"), max_size=max_size, device="cuda")
            t3 = time.perf_counter()
            times[route]["net"].append((t1 - t0) * 1e3)
            times[route]["clahe"].append((t2 - t1) * 1e3)
            times[route]["e2e"].append((t3 - t2) * 1e3)
    med = {r: {k: statistics.median(v[1:]) for k, v in t.items()} for r, t in times.items()}  # first run warms up
    for route, m in med.items():
        print(
            f"  warm per image, {route}: net {m['net']:.3f} ms, Lab-CLAHE {m['clahe']:.3f} ms, "
            f"end to end (decode to 3 PNGs written) {m['e2e']:.3f} ms"
        )
    print(f"  packed net / standard net at 1088x1920: {med[names[1]]['net'] / med[names[0]]['net']:.4f}")
    return med


def profile_phase(torch, photo: Path) -> None:
    """Phase 8: device time by kernel over 3 warm forwards of each route
    (torch.profiler), and the device's busy share of the forwards' wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import load_image

    img, _ = load_image(str(photo), 1920)
    x = torch.from_numpy(img).to("cuda")[None]
    n = 3
    for packed in (False, True):
        fn = cli.build_apply_fn(Config(mode="enhance", packed_inference=packed), torch.device("cuda"))
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            raise AssertionError("the profiler recorded no device time")
        device_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
        route = "packed" if packed else "standard"
        print(
            f"  {route} forward: {device_ms:.3f} device ms of {wall_ms:.3f} wall ms per forward "
            f"(device busy {device_ms / wall_ms:.3f}); top kernels, device ms per forward:"
        )
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / n / 1e3:9.3f}  x{e.count // n:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from PIL import Image

    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.ops import clahe_gather as cg
    from retinex_tpu_torch.ops import fused_blocks as fb

    line = gpu_line()
    print(f"device: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("phase 1: build")
    for stem, built in _kernels.build().items():
        print(f"  {built.path.name}: built in {built.seconds:.2f} s")
        for ln in built.report.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                print(f"  ptxas ({stem}): {ln.strip()}")

    print("phase 2: K1-K3 against their plain versions")
    recs = clahe_kernel_phase(torch, cg, 1088, 1920, seed=0)
    clahe_kernel_phase(torch, cg, 2160, 3840, seed=1)

    print("phase 3: K4-K6 and K11 against their plain versions")
    k4_k6 = FAM_KERNELS[:3]
    fam = [fam_kernel_phase(torch, fb, s, seed=2 + i, timed=k4_k6) for i, s in enumerate(FAM_SHAPES)]
    fam_1080 = [
        fam_kernel_phase(torch, fb, s, seed=5 + i, timed=("fam_tail_apply",)) for i, s in enumerate(FAM_SHAPES_1080)
    ]
    fam_kernel_phase(torch, fb, FAM_RAGGED, seed=4)
    for name in FAM_KERNELS:
        per = [r[name] for r in (fam if name in k4_k6 else fam_1080)]
        recs[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in per),
            ms=sum(r["ms"] for r in per),
            plain_ms=sum(r["plain_ms"] for r in per),
            bound=(sum(r["bound"][0] for r in per), per[0]["bound"][1]),
        )
    fam_ms = sum(recs[n]["ms"] for n in k4_k6)
    print(f"  K4-K6 device ms per image at 1088x1920 (scale-1 + scale-2 launches): {fam_ms:.4f}")
    print(f"  K11 device ms per image at 1080x1920: {recs['fam_tail_apply']['ms']:.4f}")

    modules = (cg, fb)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        src = REPO / "data" / "convergence" / "lowlight_000.png"
        photo = workdir / "photo1080.png"
        small = workdir / "photo512.png"
        small_flagless = workdir / "photo480.png"
        with Image.open(src) as im:
            im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
            im.convert("RGB").resize((512, 288), Image.BILINEAR).save(small)
            im.convert("RGB").resize((480, 264), Image.BILINEAR).save(small_flagless)

        print("phase 4: the standard route through the CLI (--no-packed_inference)")
        standard_phase(torch, modules, photo, workdir)
        print("phase 5: the default (packed) route through the CLI")
        launches = packed_phase(torch, modules, photo, small, workdir)
        print("phase 6: the headline command with no flags (1080x1920, not letterboxed)")
        flagless = flagless_phase(torch, modules, photo, small_flagless, workdir)
        launches = {k: v + flagless[k] for k, v in launches.items()}
        print("phase 7: warm times")
        warm_phase(torch, photo, workdir)
        print("phase 8: device time by kernel")
        profile_phase(torch, photo)

    kernels = []
    for name, r in recs.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
