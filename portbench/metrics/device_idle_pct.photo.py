"""Share of the traced window with no kernel, copy or fill on the card (one photo per call), in %."""

from portbench.common import readers


def read(rc):
    return readers.idle_pct(rc)
