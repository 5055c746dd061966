"""The share of an untraced SDS step over SV3D_p's orbit in which no
kernel, copy or fill runs on the device, in %: the device's busy time a
step in the traced window over the step's time without the profiler."""


def read(trace):
    if trace.busy_s <= 0 or not trace.untraced_ms or trace.units <= 0:
        return None
    busy_ms = trace.busy_s * 1e3 / trace.units
    return 100.0 * (1.0 - busy_ms / trace.untraced_ms)
