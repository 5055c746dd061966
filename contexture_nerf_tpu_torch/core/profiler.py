"""Phase timings and traces: the port's counterpart of
contexture_nerf_tpu/core/profiler.py.

  - `Timings`: per-phase wall-clock statistics, the first call apart, and
    the sync-to-sync windows of asynchronous loops (`note_window`), dumped
    to timings.json with the reference's keys;
  - `phase(name)`: a wall-clock block that is also a
    `torch.profiler.record_function` range, so phases show in a trace. It
    synchronises the card only with block=True, where the reference blocks;
  - `annotate(name)`: the decorator form;
  - `span(name)`: a range on the profiler's clock while `torch.profiler`
    records, and nothing at all otherwise: the spans inside the SDS step,
    the teacher's passes and the kernel wrappers;
  - `host_read(x, cause)`: a device-to-host read of a scalar inside a
    `sync.<cause>` span, so a trace counts the program's syncs;
  - `start_trace`/`stop_trace`: a `torch.profiler` trace of the CPU and the
    card, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import numbers
import time
from collections import defaultdict
from functools import wraps
from pathlib import Path
from typing import Dict, Optional

import torch


class Timings:
    """Per-phase wall-clock stats. The first call of each phase is reported
    apart (it builds kernels and warms caches). Kernel launches return
    before the card finishes, so the wall time of a loop phase is mostly
    host dispatch; callers record `note_window(name, iters, seconds)`
    between real device syncs, and summary() reports that device-inclusive
    `window_iter_ms` beside the dispatch-only `steady_mean_ms`."""

    def __init__(self):
        self.first: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.win_totals: Dict[str, float] = defaultdict(float)
        self.win_iters: Dict[str, int] = defaultdict(int)
        self.win_counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, dt: float):
        if name not in self.first:
            self.first[name] = dt
        else:
            self.totals[name] += dt
            self.counts[name] += 1

    def note_window(self, name: str, iters: int, seconds: float):
        """Record a sync-to-sync window covering `iters` dispatched steps;
        the caller must have waited on a device value at both ends, so
        `seconds` includes the card's work (unlike add()'s dispatch
        time)."""
        if iters <= 0:
            return
        self.win_totals[name] += seconds
        self.win_iters[name] += iters
        self.win_counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k in set(self.first) | set(self.win_totals):
            n = self.counts[k]
            out[k] = {
                "first_call_s": round(self.first[k], 4)
                if k in self.first else None,
                "steady_count": n,
                "steady_mean_ms": round(1000 * self.totals[k] / n, 3)
                if n else None,
                "total_s": round(self.first.get(k, 0.0) + self.totals[k], 4),
            }
            if self.win_iters[k]:
                out[k]["window_iter_ms"] = round(
                    1000 * self.win_totals[k] / self.win_iters[k], 3)
                out[k]["windows"] = self.win_counts[k]
        return out

    def dump(self, path: Path):
        Path(path).write_text(json.dumps(self.summary(), indent=1))


GLOBAL_TIMINGS = Timings()


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, timings: Optional[Timings] = None,
          block: bool = False):
    """Wall-clock + trace phase. block=True synchronises the card at the
    end (for measurement only, never in a production loop)."""
    t = timings or GLOBAL_TIMINGS
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if block:
        _sync()
    t.add(name, time.perf_counter() - t0)


_NO_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A `record_function` range named `name` while the profiler records
    (its events then share the trace's clock with the kernels launched
    inside); otherwise one shared no-op context: no range, no clock read,
    no allocation. Names beginning `pb.` are the benchmark's own."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_read(x, cause: str):
    """int(x) for an integer or boolean scalar tensor, float(x) otherwise,
    inside a `sync.<cause>` span: every device-to-host read of the SDS loop
    goes through here, so the `sync.*` spans of a step are its syncs. A
    number that is no tensor (a draw given from outside) waits for nothing:
    int(x) or float(x), no span."""
    if not torch.is_tensor(x):
        return int(x) if isinstance(x, numbers.Integral) else float(x)
    with span("sync." + cause):
        return float(x) if x.is_floating_point() else int(x)


def annotate(name: str, timings: Optional[Timings] = None):
    def deco(fn):
        @wraps(fn)
        def wrapper(*a, **kw):
            with phase(name, timings):
                return fn(*a, **kw)
        return wrapper
    return deco


_TRACE = {}


def start_trace(log_dir: str = "build/trace"):
    """Start a torch.profiler trace of the CPU and, where there is one, the
    card; `stop_trace` writes it to log_dir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _TRACE["prof"], _TRACE["dir"] = prof, log_dir
    return log_dir


def stop_trace():
    prof = _TRACE.pop("prof")
    _sync()
    prof.__exit__(None, None, None)
    out = Path(_TRACE.pop("dir"))
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    return prof
