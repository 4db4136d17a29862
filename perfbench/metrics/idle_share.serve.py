"""% of the profiled units' wall time in which no device operation ran."""

from perfbench.lib import readers


def read(run):
    return readers.idle_share(run)
