"""The program's own spans in a traced window, for the per-layer readers.

The port opens `record_function` ranges of its own while the profiler
records (`contexture_nerf_tpu_torch/core/profiler.py` `span`): the SDS
step's stages `sds.*`, the teacher's passes `teacher.*`, the kernel
wrappers `k6.fwd`, `k6.bwd` and `attn.kernel`, and a `sync.<cause>` span
around each read of a device value on the host. `tracekit.Trace` keeps
them in `trace.cpu` beside the host operations, on the clock of the
kernels. Here only what lies inside the benchmark's `pb.unit` spans (the
steps) counts: a span by its start, a kernel by the start of the host call
that launched it, on any thread (the backward launches from autograd's
own). A span the program does not open reads None, never 0.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench.tracekit import _union

STAGES = ("sds.draw", "sds.render", "sds.encode", "sds.teacher", "sds.loss",
          "sds.backward", "sds.adam", "sds.out")


def intervals(trace, name: str, prefix: bool = False
              ) -> List[Tuple[float, float]]:
    """(start, end) in µs of each host event named `name` (or, with
    `prefix`, whose name starts with it) that starts inside a step."""
    return [(a, b) for a, b, n in trace.cpu
            if (n.startswith(name) if prefix else n == name)
            and trace.in_span("pb.unit", a)]


def launched_us(trace, spans: List[Tuple[float, float]]) -> float:
    """Device µs of the kernels launched inside the union of `spans`."""
    iv = _union(spans)
    starts = [a for a, _ in iv]
    total = 0.0
    for _, _, dur, launch in trace.kernels:
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= iv[i][1]:
            total += dur
    return total


def device_ms(trace, name: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside the span `name`."""
    iv = intervals(trace, name)
    if not iv or trace.units <= 0:
        return None
    return launched_us(trace, iv) / 1e3 / trace.units


def mean_us(trace, name: str) -> Optional[float]:
    """Mean host µs of one span `name` (the profiler's own cost in)."""
    iv = intervals(trace, name)
    return sum(b - a for a, b in iv) / len(iv) if iv else None


def per_step(trace, name: str, prefix: bool = False) -> Optional[float]:
    """Events named `name` (or starting with it) a step; None where the
    program opens no `sds.step` span, and so could not have named any."""
    if trace.units <= 0 or not intervals(trace, "sds.step"):
        return None
    return len(intervals(trace, name, prefix)) / trace.units


def stage_coverage(trace) -> Tuple[float, float]:
    """(device µs of the kernels launched inside the step's stage spans,
    device µs of those launched inside `pb.unit`): the share of a step's
    device time that the stages name."""
    stages = [iv for s in STAGES for iv in intervals(trace, s)]
    return (launched_us(trace, stages),
            launched_us(trace, trace.spans.get("pb.unit", [])))
