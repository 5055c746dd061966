"""Device time of the kernels launched inside the program's `sds.encode`
spans (the VAE encode of the 21 frames and of the sampled frame, and the
frame's graft into the latents), per SDS step, in ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.encode")
