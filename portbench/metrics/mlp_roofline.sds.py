"""The texture MLP's forward and backward (the step's point counts, 481,024
multiply-adds a point) at the bf16 peak, over the device time of the MLP
kernels (names with `mlp_`) the step launches, in %."""

from portbench.tracekit import PEAK_BF16_FLOPS


def read(trace):
    us = sum(k[2] for k in trace.kernels_in("pb.unit") if "mlp_" in k[0])
    if us <= 0 or trace.units <= 0:
        return None
    bound_s = trace.work["mlp_flops"] / PEAK_BF16_FLOPS
    return 100.0 * bound_s / (us / 1e6 / trace.units)
