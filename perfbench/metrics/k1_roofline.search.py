"""% of K1a-K1d's byte bound at 3.35 TB/s: their bytes a step over their device time a step."""

from perfbench.lib import readers


def read(run):
    return readers.k1_roofline(run)
