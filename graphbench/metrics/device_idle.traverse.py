"""Share of the traced window in which no operation ran on the device,
from the profiler's trace (``gbharness.trace.idle_percent``)."""

from gbharness import trace


def read(ctx):
    return trace.idle_percent(ctx)
