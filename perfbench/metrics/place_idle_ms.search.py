"""Device idle while the host was in the batch placer's `place` spans (their
`h2d` copies included), in ms a profiled search step."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("place",))
