"""Host milliseconds in enhance.load_image per request."""

from portbench.common import readers


def read(rc):
    return readers.span_ms_per_unit(rc, "decode")
