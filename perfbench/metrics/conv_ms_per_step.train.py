"""Device ms a profiled step in convolution kernels: cuDNN's (its layout
transposes and FFT convolutions among them) and PyTorch's own depthwise
ones."""

from perfbench.lib import readers


def read(run):
    return readers.per_unit_ms(run, ("convolution",))
