"""The port's kernels (K1-K6) on the directory route: the sum of their bounds over the sum of their device seconds, in %."""

from portbench.common import readers


def read(rc):
    return readers.kernel_roofline_pct(rc)
