"""Device time of the kernels launched inside the program's `sds.teacher`
span (FLUX.1 Depth's one MMDiT call at batch 1 over 2,400 image and 512
text tokens, with the VP noising before it), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.teacher")
