"""The port's package data: every source under ``retinex_tpu_torch/csrc/``
(the CUDA kernels and the host library ``zstd_decode.cpp``, which
``ops/_kernels.py`` build on first use) matches a ``package-data`` glob of
``pyproject.toml``, so an install that is not editable ships it."""

import fnmatch
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "retinex_tpu_torch"
SOURCES = sorted(p.relative_to(PACKAGE).as_posix() for p in (PACKAGE / "csrc").iterdir() if p.is_file())


def _globs() -> list[str]:
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["retinex_tpu_torch"]


@pytest.mark.parametrize("source", SOURCES)
def test_every_csrc_source_is_package_data(source):
    assert any(fnmatch.fnmatch(source, g) for g in _globs()), f"{source} matches none of {_globs()}"


def test_the_sources_include_the_host_library():
    assert {"csrc/zstd_decode.cpp", "csrc/clahe_lab.cu"} <= set(SOURCES)
