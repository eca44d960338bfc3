"""device.idle_pct: 100 less the share of the traced window in which
some device operation (kernel, copy, memset) ran, from the profiler:
the union of their intervals, in %."""


def read(w):
    if w.busy_s is None:
        return None
    return 100 * (1 - w.busy_s / w.seconds)
