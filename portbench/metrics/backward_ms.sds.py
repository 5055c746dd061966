"""Device time of the kernels launched inside the program's `sds.backward`
span (the loss's backward through the VAE encode, the composite or the
lattice gather and the MLP, on autograd's thread too), per SDS step, in
ms."""

from portbench import spanread


def read(trace):
    return spanread.device_ms(trace, "sds.backward")
