"""Device time of the kernels launched inside the program's `k6.bwd` spans
(K6's backward: the plain version's recompute and its gradient, on
autograd's thread), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "k6.bwd")
