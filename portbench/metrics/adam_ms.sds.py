"""Device time of the kernels launched inside the program's `sds.adam`
span (the gradient norm and Adam's step), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.adam")
