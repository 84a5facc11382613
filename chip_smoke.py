#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (retinex_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; no phase is skipped):

1. The card's name and power limit; build the CUDA kernels from
   ``retinex_tpu_torch/csrc`` (nvcc, printing the seconds and ptxas report).
2. Kernels: on a seeded u8 frame at 1088x1920 (the main path's shape) and at
   2160x3840 (a cell width of 240 columns), each kernel is held to its plain
   PyTorch version on the card: K1 (lab_fwd_u8) and K3 (clahe_apply_u8) within
   1 level on under 1e-4 of the bytes, K2 (clahe_tables) identical. Median
   kernel times over 25 launches (CUDA events) at both shapes.
3. Slice: the port's CLI, ``--mode enhance --max_size 1920
   --no-packed_inference``, on a 1920x1080 PNG upscaled from
   ``data/convergence/lowlight_000.png``, with untrained weights from seed 0.
   The three PNGs must exist and every kernel's launch count must have risen.
   The enhanced image is held to the port's CPU run on the same weights
   (max 3 levels, mean under 0.05 levels). Warm per-image times of the net,
   of CLAHE and end to end.

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
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
REPLACES = {
    "lab_fwd_u8": "retinex_tpu/ops/clahe_gather.py:874",
    "clahe_tables": "retinex_tpu/ops/clahe_gather.py:648",
    "clahe_apply_u8": "retinex_tpu/ops/clahe_gather.py:931",
}
SOURCE = "retinex_tpu_torch/csrc/clahe_lab.cu"


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


def kernel_phase(torch, cg, h: int, w: int, seed: int) -> dict:
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


def slice_phase(torch, cg, workdir: Path) -> dict[str, int]:
    """Drive the CLI on a 1080p photo; check the outputs; return launches."""
    from PIL import Image

    from retinex_tpu_torch import cli
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.infer.enhance import enhance_single_image, load_image
    from retinex_tpu_torch.ops.clahe import clahe_lab_rgb

    src = REPO / "data" / "convergence" / "lowlight_000.png"
    photo = workdir / "photo1080.png"
    with Image.open(src) as im:
        im.convert("RGB").resize((1920, 1080), Image.BILINEAR).save(photo)
    out_dir = workdir / "out_cuda"
    args = [
        "--mode", "enhance", "--input_path", str(photo), "--output_dir", str(out_dir),
        "--max_size", "1920", "--no-packed_inference", "--device", "cuda",
    ]

    cg.reset_launches()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(cg.LAUNCHES)
    print(f"  CLI run (cold, includes model build): {cold_s:.3f} s; kernel launches {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path did not launch {name}")
    pngs = [out_dir / f"photo1080_{k}.png" for k in ("enhanced", "illumination", "comparison")]
    for p in pngs:
        if not p.is_file():
            raise AssertionError(f"missing output {p}")
    got = np.asarray(Image.open(pngs[0]).convert("RGB"))
    if got.shape != (1088, 1920, 3):
        raise AssertionError(f"enhanced PNG has shape {got.shape}, expected (1088, 1920, 3)")

    # The port's CPU run on the same (seeded) weights, plain versions throughout.
    cpu_cfg = Config(mode="enhance", packed_inference=False, device="cpu")
    cpu_apply = cli.build_apply_fn(cpu_cfg, torch.device("cpu"))
    t0 = time.perf_counter()
    enh_cpu, _, _ = enhance_single_image(cpu_apply, str(photo), "", max_size=1920, save_outputs=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    want = (np.clip(enh_cpu.numpy(), 0.0, 1.0) * 255).astype(np.uint8)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(
        f"  enhanced vs the CPU run ({cpu_s:.1f} s): max {int(d.max())} levels, "
        f"mean {float(d.mean()):.5f} levels, {float((d > 0).mean()):.2e} of bytes differ"
    )
    if d.max() > 3 or d.mean() >= 0.05:
        raise AssertionError("the card's enhanced output disagrees with the CPU run")
    if not np.isfinite(enh_cpu.numpy()).all():
        raise AssertionError("non-finite values in the CPU run")

    # Warm per-image times on the card, the same weights.
    apply_fn = cli.build_apply_fn(Config(mode="enhance", packed_inference=False), torch.device("cuda"))
    img, _ = load_image(str(photo), 1920)
    net_ms, clahe_ms, e2e_ms = [], [], []
    for _ in range(6):
        x = torch.from_numpy(img).to("cuda")[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enh, _, _ = apply_fn(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        clahe_lab_rgb(torch.clamp(enh, 0.0, 1.0))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enhance_single_image(apply_fn, str(photo), str(workdir / "out_warm"), max_size=1920, device="cuda")
        t3 = time.perf_counter()
        net_ms.append((t1 - t0) * 1e3)
        clahe_ms.append((t2 - t1) * 1e3)
        e2e_ms.append((t3 - t2) * 1e3)
    med = lambda v: statistics.median(v[1:])  # noqa: E731 (first run warms up)
    print(
        f"  warm per image at 1088x1920: net {med(net_ms):.3f} ms, Lab-CLAHE {med(clahe_ms):.3f} ms, "
        f"end to end (decode to 3 PNGs written) {med(e2e_ms):.3f} ms"
    )
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from retinex_tpu_torch.ops import _kernels
    from retinex_tpu_torch.ops import clahe_gather as cg

    line = gpu_line()
    print(f"device: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("phase 1: build")
    path, seconds, report = _kernels.build()
    print(f"  {path.name}: built in {seconds:.2f} s")
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln.lower():
            print(f"  ptxas: {ln.strip()}")

    print("phase 2: kernels against their plain versions")
    recs = kernel_phase(torch, cg, 1088, 1920, seed=0)
    kernel_phase(torch, cg, 2160, 3840, seed=1)

    print("phase 3: the enhance slice through the CLI")
    with tempfile.TemporaryDirectory() as tmp:
        launches = slice_phase(torch, cg, Path(tmp))

    kernels = []
    for name, r in recs.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
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
