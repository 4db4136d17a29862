"""Device operations (kernels, copies, sets) a profiled step."""

from perfbench.lib import readers


def read(run):
    return readers.launches(run)
