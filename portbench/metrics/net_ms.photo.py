"""Milliseconds between CUDA events around the net's apply_fn, per request."""

from portbench.common import readers


def read(rc):
    return readers.span_ms_per_unit(rc, "net")
