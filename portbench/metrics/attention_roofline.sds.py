"""The towers' attention calls (4 B H Sq (Skv + Se) d FLOPs at the bf16
peak, or their bytes at the HBM rate), over the device time of the kernels
launched inside the spans around every call of the attention entry, in %."""


def read(trace):
    return trace.roofline_pct("attention", "pb.attention")
