"""Device idle while the host was in the search step's backwards
(`arch_backward`, `weight_backward`: torch.autograd.grad), in ms a
profiled step."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("arch_backward", "weight_backward"))
