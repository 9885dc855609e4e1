"""device_idle_share.<kind>: the share of the profiled window in which the
device ran no kernel, copy or set (the busy union of the profiler's device
operations; the window records the device's activity alone)."""
from fedbench import yardstick


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return yardstick.idle_share(t.busy_s, t.window_s)
