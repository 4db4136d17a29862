"""Train images of the fixed-model steps completed in the window, a second of the window."""

from perfbench.lib import readers


def read(run):
    return readers.rate(run)
