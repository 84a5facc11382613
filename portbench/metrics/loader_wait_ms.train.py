"""Host milliseconds waiting in next() on the train loader, per step."""

from portbench.common import readers


def read(rc):
    return readers.span_ms_per_unit(rc, "loader_wait")
