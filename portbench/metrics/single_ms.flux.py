"""Device time of the kernels launched inside the program's `flux.single`
spans (the 38 single-stream blocks: modulation, the fused qkv + MLP
linear, QK norm, the joint attention, the output linear), per SDS step,
in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "flux.single")
