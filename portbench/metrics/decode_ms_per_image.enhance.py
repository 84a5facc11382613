"""Host milliseconds in batch_driver.decode_bucket per image of the window."""

from portbench.common import readers


def read(rc):
    return readers.span_ms_per_unit(rc, "decode")
