"""Nothing the benchmark runs loads JAX, Flax or the JAX package; the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "retinex_tpu"}


def _modules() -> list[str]:
    mods = ["portbench.run", "portbench.calibrate", "portbench.faults"]
    for sub in ("common", "counts", "drivers", "reference"):
        mods += [f"portbench.{sub}.{p.stem}" for p in sorted((BENCH / sub).glob("*.py")) if p.stem != "__init__"]
    return mods


def test_imports_load_no_jax():
    metrics = [str(p) for p in sorted((BENCH / "metrics").glob("*.py"))]
    code = (
        "import sys, importlib, importlib.util, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"for i, p in enumerate({metrics!r}):\n"
        "    s = importlib.util.spec_from_file_location(f'metric{i}', p); s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "import retinex_tpu_torch.cli, retinex_tpu_torch.train.trainer, retinex_tpu_torch.infer.enhance\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    loaded = set(__import__("json").loads(proc.stdout.splitlines()[-1]))
    assert "retinex_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"retinex_tpu_torch"}, f"{path.name} imports {name}"
                assert top != "portbench" or name.startswith("portbench.reference"), f"{path.name} imports {name}"


def test_run_refuses_a_loaded_jax_package():
    from portbench import run

    sys.modules.setdefault("retinex_tpu", type(sys)("retinex_tpu"))
    try:
        assert run.forbidden_modules() == ["retinex_tpu"]
    finally:
        del sys.modules["retinex_tpu"]
