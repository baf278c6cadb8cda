"""device_idle_share: 1 - (the union of the device's activity intervals)
/ (the host wall time) over a profiled stretch of the timed path's
requests (torch.profiler), in %."""


def read(run):
    t = run.trace_data
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t else None
