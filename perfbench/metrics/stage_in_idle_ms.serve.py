"""Device idle while the host was in the Predictor's `stage_in` spans
(the host tensor, its padding, the `h2d` copy), in ms a profiled request."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("stage_in",))
