"""GroupNorm's calls (x read once, y written once) at the HBM rate, over the
device time of the kernels launched inside the benchmark's spans around
every GroupNorm module call, in %."""


def read(trace):
    return trace.roofline_pct("groupnorm", "pb.groupnorm")
