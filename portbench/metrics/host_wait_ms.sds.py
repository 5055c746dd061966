"""Host time a step spends blocked on device reads (the tile index's and
the loss's `.item()`, stream synchronisations), per step, in ms."""


def read(trace):
    if trace.units <= 0 or not trace.spans.get("pb.unit"):
        return None
    return trace.host_wait_us("pb.unit") / 1e3 / trace.units
