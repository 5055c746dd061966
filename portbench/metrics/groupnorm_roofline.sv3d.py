"""K6's traffic a step (every GroupNorm call's x read once and y written
once, by portbench/work/sv3d.py) at the HBM rate, over the device time of
the kernels launched inside the program's `k6.fwd` spans, in %."""

from portbench import spanread
from portbench.tracekit import PEAK_BYTES_S


def read(trace):
    ms = spanread.device_ms(trace, "k6.fwd")
    nbytes = trace.work.get("k6_bytes")
    if not ms or not nbytes:
        return None
    return 100.0 * nbytes / PEAK_BYTES_S / (ms / 1e3)
