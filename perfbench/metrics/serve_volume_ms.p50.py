"""The median request time of the unprofiled requests of a traced run, in ms."""

from perfbench.lib import readers


def read(run):
    return readers.percentile_ms(run, 50, unprofiled=True)
