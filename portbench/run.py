"""The port's benchmark: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` and the cell's files (``portbench/workloads/<cell>.json``,
its configuration ``portbench/configs/<config>.json`` and traffic driver
``portbench/drivers/<driver>.py``), sets up (inputs and weights from the seed,
the program, a warm-up of the cell's shapes), measures for ``--seconds``,
checks what the window produced against the plain reference, and prints one
JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``portbench/metrics/<metric>.py``) from
a ``torch.profiler`` trace of the window and the benchmark's own spans.

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Caches of the program's builds, at fixed paths inside the checkout.
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "retinex_tpu")


def set_cache_env() -> None:
    """PyTorch's extension and Triton's kernel caches at fixed paths in the
    checkout (the port's own CUDA libraries go to ``retinex_tpu_torch/_build/``
    there), so only a checkout's first run builds."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration's file). The cell joins
    its entry in BENCHMARK.json, its traffic's file
    (``traffic/<traffic>.json``: the driver and its parameters) and its own
    file (``workloads/<cell>.json``: the comparison's limits)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}")
    entry = entries[name]
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    cell = {**entry, **traffic, **load_json(BENCH / "workloads" / f"{name}.json")}
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return bench, cell, load_json(ROOT / config["file"])


def cell_metrics(bench: dict, name: str, kind: str) -> list[dict]:
    """The end-to-end or per-layer metrics this cell reports."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def load_reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(torch, chips: int, trace=None) -> dict:
    info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_env()
    sys.path.insert(0, str(ROOT))
    bench, workload, config = load_cell(args.workload)
    chips = int(workload["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = execute(bench, args.workload, workload, config, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), chips)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    for c in checks:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return 0


def execute(bench, name, workload, config, seed, seconds, trace, device, chips=1):
    """One run of cell `name` on `device`: (the result's JSON object, the
    compared numbers). The card is not looked for here: on the CPU (the
    tests) the program takes its plain versions and the device block
    names the CPU."""
    import torch

    from portbench.common import trace as tracing
    from portbench.common.cellbase import Context
    from portbench.common.readers import ReadContext
    from portbench.common.spans import Spans
    from portbench.common.weights import scratch_dir

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    workdir = scratch_dir(f"portbench_{name}_")
    spans = Spans(enabled=trace, device=device)
    summary = launches = None
    try:
        ctx = Context(workload, config, seed, device, workdir, spans)
        print(f"set-up: interpreter and imports {time.perf_counter() - START:.3f} s", file=sys.stderr)
        cell = driver.Cell(ctx)
        cell.setup()
        sync()
        setup_s = time.perf_counter() - START

        tracer = None
        if trace:
            for module, attr, span, kind in getattr(driver, "SPANS", []):
                spans.patch(module, attr, span, kind)
            counters = Counters()
            tracer = tracing.Tracer(device)
            spans.clear()
            tracer.start()
        win = cell.window(seconds)
        sync()
        if tracer is not None:
            tracer.stop()
            spans.restore()
            launches = counters.read()
            summary = tracer.summary()
        dev = device_info(torch, chips, summary) if cuda else {"platform": "cpu", "kind": "cpu", "count": 1,
                                                              "memory_peak_bytes": 0}
        cell.release()
        checks = cell.check()
    finally:
        spans.restore()
        shutil.rmtree(workdir, ignore_errors=True)

    if trace:
        rc = ReadContext(workload=workload, config=config, window=win, summary=summary, spans=spans, cell=cell)
        for key, count in sorted(launches.items()):
            print(f"launches per unit: {key} {count / max(win.done, 1):.3f}", file=sys.stderr)
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_reader(m["name"])(rc)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, name, "end_to_end")}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = tracing.breakdown(summary)
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


class Counters:
    """The port's launch counters, read as the launches since the window's start."""

    TABLES = (
        ("retinex_tpu_torch.ops.fused_blocks", ("LAUNCHES", "KERNEL_LAUNCHES", "BF16_LAUNCHES")),
        ("retinex_tpu_torch.ops.clahe_gather", ("LAUNCHES",)),
        ("retinex_tpu_torch.ops.clahe_luma", ("LAUNCHES",)),
    )

    def __init__(self):
        self.tables = []
        for module, names in self.TABLES:
            mod = importlib.import_module(module)
            for n in names:
                table = getattr(mod, n, None)
                if isinstance(table, dict):
                    self.tables.append((f"{module.rsplit('.', 1)[1]}.{n}", table))
        self.start = {label: dict(t) for label, t in self.tables}

    def read(self) -> dict[str, int]:
        out = {}
        for label, table in self.tables:
            for k, v in table.items():
                d = v - self.start[label].get(k, 0)
                if d:
                    out[f"{label}.{k}"] = d
        return out


if __name__ == "__main__":
    sys.exit(main())
