"""Device time of the kernels launched inside the teacher's CFG call, per
denoising step of a grid, in ms."""


def read(trace):
    us = trace.device_us_in("pb.teacher")
    return us / 1e3 / trace.sub_units if us > 0 and trace.sub_units else None
