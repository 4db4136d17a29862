"""% of the f32 peak (67 TFLOP/s): the reference's FLOPs of the unprofiled units over their time."""

from perfbench.lib import readers


def read(run):
    return readers.mfu(run)
