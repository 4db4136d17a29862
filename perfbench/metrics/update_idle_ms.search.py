"""Device idle while the host was in the search step's updates
(`arch_update`, `weight_update`: the clip, Adam's and SGD's steps,
zero_grad), in ms a profiled step."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("arch_update", "weight_update"))
