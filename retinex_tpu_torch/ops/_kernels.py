"""Build and load the port's CUDA kernels.

The sources under ``retinex_tpu_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles them straight into a shared library (no PyTorch headers:
seconds, not minutes) and ``ctypes`` loads it. The library is built on first
use, once per process, into ``retinex_tpu_torch/_build/`` under a name that
carries the hash of the source and the flags, so a changed source is rebuilt
and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the port
on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "clahe_lab.cu"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math, and no FMA contraction: the colour math must round
# exactly as the plain versions do (see the note at the top of the source).
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "--ptxas-options=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, sizes, the stream last)
    "clahe_lab_fwd_u8": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P),
    "clahe_tables": (_P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "clahe_apply_u8": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libclahe_lab_{digest}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if this source has not been built yet.

    Returns (library path, build seconds (0.0 when reused), ptxas report)."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{report}")
    log_path.write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return lib, seconds, report


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one launch function; raise on a nonzero cudaGetLastError()."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
