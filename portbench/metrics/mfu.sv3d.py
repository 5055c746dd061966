"""The model FLOPs of one SDS step over SV3D_p's orbit by the
benchmark's own count (portbench/work/sv3d.py: products forward, the
backward through the sampled frame, no recomputation) over the untraced
step time at 989 TFLOP/s, in %."""

from portbench.tracekit import PEAK_BF16_FLOPS


def read(trace):
    if not trace.untraced_ms or trace.untraced_ms <= 0:
        return None
    return 100.0 * trace.work["unit_flops"] / (
        trace.untraced_ms / 1e3 * PEAK_BF16_FLOPS)
