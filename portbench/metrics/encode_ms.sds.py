"""Device time of the kernels launched inside the program's `sds.encode`
spans (the VAE encodes of the canvas and of the backward slice, and the
slice's graft into the latent), per SDS step, in ms. Their backward is in
`backward_ms.sds`."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.encode")
