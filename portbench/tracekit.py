"""The traced window: the benchmark's own spans around the program's layers,
torch.profiler over the window, and the reduction of its trace to what the
per-layer readers need.

Spans (record_function ranges, named `pb.*`) are opened by the benchmark
around calls into the program: `pb.window` around the whole window,
`pb.unit` around each step or job, and `Spans` adds `pb.teacher` around the
teacher's CFG call, `pb.groupnorm` around every GroupNorm module call (with
its bytes: x read once, y written once) and `pb.attention` around every
call of the towers' attention entry (with its FLOPs and bytes). A kernel
belongs to a span when the host call that launched it started inside the
span. The profiler's chrome trace is read back from a file under TMPDIR and
deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
PEAK_BYTES_S = 3.35e12  # HBM3, H100 SXM data sheet
SYNC_OPS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
            "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


class Spans:
    """Install the benchmark's spans on a program's towers; `remove()` takes
    them away. `calls[name]` lists each call's (flops, bytes)."""

    def __init__(self, torch, teacher, towers, groupnorm_cls, layers_module):
        from torch.autograd.profiler import record_function

        self.calls: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.handles = []
        self.teacher = teacher
        orig_cfg = teacher._cfg_v_pred

        def cfg_v_pred(*a, **k):
            with record_function("pb.teacher"):
                return orig_cfg(*a, **k)

        teacher._cfg_v_pred = cfg_v_pred
        open_ranges = []

        def pre(mod, inputs):
            x = inputs[0]
            out = torch.empty((), dtype=mod.out_dtype or x.dtype)
            self.calls["groupnorm"].append(
                (0.0, float(x.numel() * (x.element_size()
                                         + out.element_size()))))
            r = record_function("pb.groupnorm")
            r.__enter__()
            open_ranges.append(r)

        def post(mod, inputs, output):
            open_ranges.pop().__exit__(None, None, None)

        for tower in towers:
            for m in tower.modules():
                if isinstance(m, groupnorm_cls):
                    self.handles.append(m.register_forward_pre_hook(pre))
                    self.handles.append(m.register_forward_hook(post))
        self.layers = layers_module
        orig_att = layers_module.attention
        self.orig_att = orig_att

        def attention(q, k, v, extra_k=None, extra_v=None):
            B, H, sq, d = q.shape
            skv = k.shape[2] + (0 if extra_k is None else extra_k.shape[2])
            flops = 4.0 * B * H * sq * skv * d
            nbytes = q.element_size() * B * H * d * (2 * sq + 2 * skv)
            self.calls["attention"].append((flops, float(nbytes)))
            with record_function("pb.attention"):
                return orig_att(q, k, v, extra_k=extra_k, extra_v=extra_v)

        layers_module.attention = attention

    def remove(self):
        for h in self.handles:
            h.remove()
        self.layers.attention = self.orig_att
        del self.teacher._cfg_v_pred


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


class Trace:
    """A traced window, reduced. Times are in microseconds of the trace's
    clock; the reader-facing numbers say their units. `units` steps or jobs
    ran in it; `sub_units` teacher calls (generation's denoising steps)."""

    def __init__(self, events: List[dict], units: int, calls: dict,
                 work: dict, untraced_ms: float, sub_units: int = 0):
        self.units = units
        self.sub_units = sub_units
        self.calls = calls
        self.work = work
        self.untraced_ms = untraced_ms
        launch_ts: Dict[int, float] = {}
        self.kernels: List[Tuple[str, float, float, float]] = []
        device_iv, self.cpu, self.spans = [], [], defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = ts
                self.cpu.append((ts, ts + dur, e.get("name", "")))
            elif cat == "kernel":
                self.kernels.append((e.get("name", ""), ts, dur,
                                     e.get("args", {}).get("correlation")))
                device_iv.append((ts, ts + dur))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                device_iv.append((ts, ts + dur))
            elif cat == "user_annotation":
                name = e.get("name", "")
                if name.startswith("pb."):
                    self.spans[name].append((ts, ts + dur))
                self.cpu.append((ts, ts + dur, name))
            elif cat == "cpu_op":
                self.cpu.append((ts, ts + dur, e.get("name", "")))
        for k in self.spans:
            self.spans[k].sort()
        self.kernels = [(n, ts, dur, launch_ts.get(c, ts))
                        for n, ts, dur, c in self.kernels]
        win = self.spans.get("pb.window") or [(0.0, 0.0)]
        self.lo, self.hi = win[0]
        self.busy = _clip(_union(device_iv), self.lo, self.hi)
        self.window_s = (self.hi - self.lo) / 1e6
        self.busy_s = _length(self.busy) / 1e6
        self.cpu.sort()
        self.cpu_starts = [c[0] for c in self.cpu]

    def ms_per_unit(self) -> float:
        return self.window_s * 1e3 / max(self.units, 1)

    def in_span(self, span: str, ts: float) -> bool:
        iv = self.spans.get(span, [])
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= ts <= iv[i][1]

    def kernels_in(self, span: str) -> List[Tuple[str, float, float, float]]:
        return [k for k in self.kernels if self.in_span(span, k[3])]

    def device_us_in(self, span: str) -> float:
        return sum(k[2] for k in self.kernels_in(span))

    def host_wait_us(self, span: str = "pb.unit") -> float:
        waits = _union([(a, b) for a, b, n in self.cpu if n in SYNC_OPS])
        total = 0.0
        for lo, hi in self.spans.get(span, []):
            total += _length(_clip(waits, lo, hi))
        return total

    def roofline_pct(self, call: str, span: str) -> Optional[float]:
        """The least time of the calls (FLOPs at the bf16 peak or bytes at
        the HBM rate, whichever is longer, call by call) over the device
        time of the kernels launched inside their spans, in %."""
        calls = self.calls.get(call, [])
        dev_us = self.device_us_in(span)
        if not calls or dev_us <= 0:
            return None
        bound_s = sum(max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES_S)
                      for f, b in calls)
        return 100.0 * bound_s / (dev_us / 1e6)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.lo
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.hi > t:
            gaps.append((t, self.hi))
        return gaps

    def host_at(self, ts: float) -> str:
        """The innermost benchmark span and host operation open at ts."""
        i = bisect.bisect_right(self.cpu_starts, ts) - 1
        span, op, seen = None, None, 0
        while i >= 0 and seen < 50000 and (span is None or op is None):
            a, b, n = self.cpu[i]
            if a <= ts < b:
                if n.startswith("pb."):
                    span = span or n
                else:
                    op = op or n
            i -= 1
            seen += 1
        return f"{span or 'no span'} / {op or 'no op'}"


def breakdown(trace: Trace) -> dict:
    """The ten device operations with most time and the ten host activities
    with the most idle device time in the window, in seconds."""
    by_kernel: Dict[str, float] = defaultdict(float)
    for n, ts, dur, _ in trace.kernels:
        if trace.lo <= ts <= trace.hi:
            by_kernel[n[:120]] += dur / 1e6
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:400]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        by_host[trace.host_at(a)[:120]] += (b - a) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def profile_units(torch, spans: Spans, units: int, unit) -> List[dict]:
    """The trace of `units` calls of unit(), each in a `pb.unit` span, all
    in a `pb.window` span that ends with a device sync; the spans' calls
    are those of the window that is kept."""
    from torch.autograd.profiler import record_function

    def body():
        spans.calls.clear()
        with record_function("pb.window"):
            for _ in range(units):
                with record_function("pb.unit"):
                    unit()
            torch.cuda.synchronize()

    return profile_window(torch, body)


def profile_window(torch, body, tries: int = 3) -> List[dict]:
    """Run body() under the profiler (host and device activity) and return
    the trace's events; a window whose trace holds no kernel is taken
    again, up to `tries` times, and then raises: an empty reading is a
    failure of the reading, never a zero."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        if any(e.get("cat") == "kernel" for e in events):
            return events
    raise RuntimeError("the profiler's trace held no kernel in "
                       f"{tries} windows")
