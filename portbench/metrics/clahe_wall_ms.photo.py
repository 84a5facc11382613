"""Milliseconds on the card's clock between CUDA events around adaptive_params.clahe_lab_rgb, per request."""

from portbench.common import readers


def read(rc):
    return readers.span_ms_per_unit(rc, "clahe")
