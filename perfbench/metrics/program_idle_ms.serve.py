"""Device idle while the host was in the Predictor's `program` spans (the
exported program's call), in ms a profiled request."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("program",))
