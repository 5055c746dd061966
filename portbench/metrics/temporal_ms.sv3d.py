"""Device time of the kernels launched inside the program's
`teacher.temporal` spans (each VideoResBlock's time_stack and each
temporal transformer's VideoTransformerBlock, with their blenders), per
SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "teacher.temporal")
