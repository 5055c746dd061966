"""Device time of the kernels launched inside the teacher's CFG call, per
SDS step, in ms."""


def read(trace):
    us = trace.device_us_in("pb.teacher")
    return us / 1e3 / trace.units if us > 0 and trace.units > 0 else None
