"""Device idle while the host was in the search step's forwards
(`arch_forward`, `weight_forward`: normalize_arch, the supernet, the
loss), in ms a profiled step."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("arch_forward", "weight_forward"))
