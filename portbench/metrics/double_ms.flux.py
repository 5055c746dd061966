"""Device time of the kernels launched inside the program's `flux.double`
spans (the 19 double-stream blocks: two streams' modulation, qkv, QK norm,
the joint attention, projections and MLPs), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "flux.double")
