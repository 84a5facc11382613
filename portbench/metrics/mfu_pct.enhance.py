"""The standard forward's FLOPs at the cell's frame, times the traced window's images per second, over the f32 peak, in %."""

from portbench.common import readers


def read(rc):
    return readers.net_mfu_pct(rc)
