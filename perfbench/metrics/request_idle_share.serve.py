"""% of the host time in the profiled requests (`serve_request` spans) in
which the device was idle between its events."""

from perfbench.lib import spans


def read(run):
    return spans.idle_share_of(run, "serve_request")
