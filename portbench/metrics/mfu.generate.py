"""The model FLOPs of one grid by the benchmark's own count (portbench/work:
the conditioning, the teacher calls and the decode) over the untraced grid
time at 989 TFLOP/s, in %."""

from portbench.tracekit import PEAK_BF16_FLOPS


def read(trace):
    if not trace.untraced_ms or trace.untraced_ms <= 0:
        return None
    return 100.0 * trace.work["unit_flops"] / (
        trace.untraced_ms / 1e3 * PEAK_BF16_FLOPS)
