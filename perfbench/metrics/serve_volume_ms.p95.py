"""The 95th percentile of every request's time, submission to masks on the host, in ms."""

from perfbench.lib import readers


def read(run):
    return readers.percentile_ms(run, 95)
