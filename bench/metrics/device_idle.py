"""device_idle: the share of the traced window in which no operation ran on
the device (the merged intervals of the profiler's device operations)."""


def read(t):
    if not t.events:
        return None
    window = (t.end_ns - t.start_ns) / 1e9
    return 100.0 * (1.0 - t.busy_s() / window)
