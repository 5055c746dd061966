"""The share of an untraced grid in which no kernel, copy or fill runs
on the device, in %: the device's busy time a grid in the traced window
over the grid's time without the profiler (which slows the host about
twofold, so the traced window's own idle share reads high)."""


def read(trace):
    if trace.busy_s <= 0 or not trace.untraced_ms or trace.units <= 0:
        return None
    busy_ms = trace.busy_s * 1e3 / trace.units
    return 100.0 * (1.0 - busy_ms / trace.untraced_ms)
