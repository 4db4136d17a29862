"""Device idle while the host was in the Predictor's `readback` spans
(argmax, uint8, the copy to the host), in ms a profiled request."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms_per_unit(run, ("readback",))
