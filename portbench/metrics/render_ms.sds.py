"""Device time of the kernels launched inside the program's `sds.render`
spans (the student: the MLP query and composite of the canvas and of the
backward slice, or the exact path's texture map, its sampling at the cached
UVs and the crops), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.render")
