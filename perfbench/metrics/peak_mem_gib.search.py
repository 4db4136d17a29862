"""torch.cuda.max_memory_allocated over the window, in GiB."""

from perfbench.lib import readers


def read(run):
    return readers.peak_gib(run)
