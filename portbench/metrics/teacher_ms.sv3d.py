"""Device time of the kernels launched inside the program's `sds.teacher`
span (SV3D_p's one CFG call of the video UNet at batch 2 x 21), per SDS
step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.teacher")
