"""Device ms a profiled step in K1a-K1d (branch_stats, apply_mix, bwd_reduce, bwd_dx)."""

from perfbench.lib import readers


def read(run):
    return readers.per_unit_ms(run, readers.K1_CLASSES)
