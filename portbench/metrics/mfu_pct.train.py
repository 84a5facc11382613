"""The training step's model FLOPs (net forward and backward, VGG19 to pool3), times steps per second, over the f32 peak, in %."""

from portbench.common import readers


def read(rc):
    return readers.train_mfu_pct(rc)
