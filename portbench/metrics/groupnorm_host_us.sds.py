"""Host time of one call of K6's wrapper (the program's `k6.fwd` span:
checks, plan, launch, count), averaged over the calls in the steps, in µs
under the profiler."""

from portbench import spanread


def read(trace):
    return spanread.mean_us(trace, "k6.fwd")
