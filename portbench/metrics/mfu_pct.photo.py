"""The standard forward's FLOPs at the photo's frame, times the traced window's requests per second, over the f32 peak, in %."""

from portbench.common import readers


def read(rc):
    return readers.net_mfu_pct(rc)
