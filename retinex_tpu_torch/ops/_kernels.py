"""Build and load the port's CUDA kernels.

Every source under ``retinex_tpu_torch/csrc/`` has a plain C interface, so
``nvcc`` compiles each one straight into its own shared library (no PyTorch
headers: seconds, not minutes) and ``ctypes`` loads it. The libraries are
built on first use, once per process, into ``retinex_tpu_torch/_build/``;
the sources that need building are compiled in parallel, one ``nvcc`` each.
Each library's name carries the hash of its source and the flags, so an
edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the port
on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math, and no FMA contraction: the colour math must round
# exactly as the plain versions do (see the note at the top of clahe_lab.cu);
# the convolution kernels and the CLAHE blends call fmaf where they mean a
# fused multiply-add.
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
_L = ctypes.c_longlong
# launch function: (source stem, argtypes: pointers, sizes, the stream last)
_SIGNATURES = {
    "clahe_lab_fwd": ("clahe_lab", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "clahe_tables": ("clahe_lab", (_P, _P, _P, _L) + (_I,) * 10 + (ctypes.c_float,) + (_I,) * 3 + (_P,)),
    "clahe_apply": ("clahe_lab", (_P, _P, _P, _P) + (_I,) * 9 + (_P,)),
    "clahe_apply_tiles": ("clahe_lab", (_P,) * 5 + (_I,) * 8 + (_P,)),
    "clahe_pallas_hist": ("clahe_lab", (_P,) * 4 + (_I,) * 8 + (_P,)),
    "clahe_pallas_apply": ("clahe_lab", (_P,) * 4 + (_I,) * 8 + (_P,)),
    "clahe_apply_table_layout": ("clahe_lab", (_I,)),
    "clahe_luma_apply_u8": ("clahe_luma", (_P,) * 5 + (_I,) * 5 + (_P,)),
    "clahe_luma_apply_u8_nhwc": ("clahe_luma", (_P,) * 5 + (_I,) * 5 + (_P,)),
    "clahe_luma_apply_u8_fused": ("clahe_luma", (_P,) * 4 + (_I,) * 5 + (_P,)),
    "fam_conv_out": ("fam_fused", (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "fam_tail_stats": ("fam_fused", (_P, _P, _P, _L, _L, _I, _P)),
    "fam_tail_apply_g1": ("fam_fused", (_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P)),
    "fam_tail_apply": ("fam_fused", (_P, _P, _P, _P, _L, _L, _I, _P)),
    "conv_direct": ("conv_direct", (_P,) * 4 + (_I,) * 15 + (_P,)),
    "conv_wgmma_bf16": ("conv_wgmma", (_P,) * 5 + (_I,) * 16 + (_P,)),
    "conv_pipelined_f32": ("conv_pipelined", (_P,) * 5 + (_I,) * 10 + (_P,)),
    "conv_wgmma_plan": ("conv_wgmma", (_I,) * 8 + (_P,)),
    "conv_pipelined_smem": ("conv_pipelined", (_I, _I)),
    "conv_narrow_f32": ("conv_narrow", (_P,) * 4 + (_I,) * 9 + (_P,)),
    "conv_narrow_plan": ("conv_narrow", (_I,) * 3 + (_P,)),
}


@dataclasses.dataclass(frozen=True)
class Built:
    """One source's library: its path, the seconds nvcc took (0.0 when the
    library was reused) and the compiler's report (ptxas registers, spills)."""

    path: Path
    seconds: float
    report: str


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build() -> dict[str, Built]:
    """Compile every source whose library is missing, all at once.

    Returns {source stem: Built}."""
    out: dict[str, Built] = {}
    running = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = library_path(src)
        log_path = lib.with_suffix(".log")
        if lib.exists():
            out[src.stem] = Built(lib, 0.0, log_path.read_text() if log_path.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for src, lib, tmp, cmd, proc, t0 in running:
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)  # atomic: another process never loads a partial file
        out[src.stem] = Built(lib, seconds, report)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.lru_cache(maxsize=1)
def libraries() -> dict[str, ctypes.CDLL]:
    """The loaded kernel libraries by source stem, built on first call."""
    libs = {stem: ctypes.CDLL(str(b.path)) for stem, b in build().items()}
    for name, (stem, argtypes) in _SIGNATURES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return libs


def stream(x) -> int:
    """PyTorch's current stream on x's card, where the kernels launch; a
    tensor off the card raises (the wrappers take CPU tensors to their plain
    versions before they get here)."""
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel path takes CUDA tensors, the plain path CPU tensors")
    return torch.cuda.current_stream(x.device).cuda_stream


# The namespace of the PyTorch operators that the serving routes' wrappers
# are registered as (``operator``).
OP_NAMESPACE = "retinex_tpu_torch"
_OPERATORS: dict[str, object] = {}


def operator(name: str, fake):
    """Decorator: a kernel's wrapper as the PyTorch operator
    ``retinex_tpu_torch::<name>`` (``torch.library.custom_op``, mutating no
    input), the wrapper's body its implementation on every device, `fake`
    its fake implementation: the output's shape and dtype from the inputs',
    which is all that ``torch.export`` and other tracers run, since a launch
    needs storage that their tensors do not have. An exported program then
    holds a call of the operator, and the operator launches the kernel.
    Registered once per process: a module imported again gets the first
    registration back."""

    def register(fn):
        if name not in _OPERATORS:
            op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", mutates_args=())(fn)
            op.register_fake(fake)
            _OPERATORS[name] = op
        return _OPERATORS[name]

    return register


def query(name: str, *args) -> int:
    """Call a library function that returns a number (not a cudaError)."""
    return getattr(libraries()[_SIGNATURES[name][0]], name)(*args)


def launch(name: str, *args) -> None:
    """Call one launch function; raise on a nonzero cudaGetLastError()."""
    err = getattr(libraries()[_SIGNATURES[name][0]], name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
