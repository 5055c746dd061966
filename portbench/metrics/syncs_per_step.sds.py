"""The program's reads of device values on the host (its `sync.*` spans,
`profiler.host_read`) per SDS step."""

from portbench import spanread


def read(trace):
    return spanread.per_step(trace, "sync.", prefix=True)
