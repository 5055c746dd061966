"""Piecewise CUDA-graph replay of the Zero123++ teacher's CFG call.

The SDS step calls the teacher once a step, with the same shapes for a
whole paint run: the write pass, the ControlNet and the read pass, some
2,400 kernel launches, which pace the step on the host. `TeacherGraphs`
captures that call as CUDA graphs and replays them, cut at every call of
the attention entry (`layers.attention`) and of a `GroupNormSiLU` module:
those calls run eagerly between two graphs, as they do without them. So
every hand-written kernel of the call (K3/K4 behind the attention entry,
K6 behind GroupNormSiLU) is launched, counted (`_build.launch_counts`) and
spanned by its own wrapper on every call; the attention route is still
chosen on the host by shape; and what wraps the attention entry or hooks
a GroupNorm module (the launch census, the benchmark's spans) sees every
call. The graphs hold the rest: convolutions, matmuls, elementwise ops.

A call with new shapes runs eagerly (kernel builds, cuBLAS and cuDNN
plans); the second captures and runs; later ones replay. Capture: the
call runs on its static inputs (copies of the arguments) while `_cutting`
hands each cut call to the recorder; there the open graph allocates the
call's output (its slot), ends and is replayed at once, the call runs on
what it computed and its output is copied into the slot, and the next
graph begins. All graphs of one call share one memory pool; the slots and
the recorded inputs of the cut calls are non-owning views of it, so the
pool reuses memory as the eager call's allocator did. Replay: copy the
arguments into the static inputs, then replay the graphs in order with the
cut calls between them, the attention entry looked up as
`layers.attention` at the time of the call, each GroupNorm called as its
module.

Between calls the graphs keep allocated only their static inputs and
static output (`static_bytes`); the teacher's transient activations live
in the pool, reserved, not allocated. The tensors a replay returns are
that static output: the next call with the same shapes overwrites them.
The graphs read the towers' parameters and buffers at the addresses they
had at capture: a change of the towers after it is made in place, or drops
the graphs (`clear`, as `set_int8` does).

Eager instead of graphs, by what the call shows: an input off the card,
an input scale (`generate`'s Euler steps), ring attention under
`sequence_parallel`, towers sharded by `tensor_parallel`, or a capture
that raised (counted in `counts["fallbacks"]`, its reason in `eager`).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import torch

from contexture_nerf_tpu_torch.core.profiler import span
from contexture_nerf_tpu_torch.diffusion import layers
from contexture_nerf_tpu_torch.ops import attention as att
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

FIRST = "first call of its shapes"

# one capture stream a device, its cuBLAS workspace made before any capture
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(s):
            # cuBLAS keeps a workspace a stream: made here, outside any
            # capture, it stays out of the graphs' pool
            a = torch.ones((64, 64), device=device, dtype=torch.bfloat16)
            torch.nn.functional.linear(a, a, a[0])
            torch.matmul(a.float(), a.float())
        torch.cuda.current_stream(device).wait_stream(s)
    return s


class _Span:
    """A device address range as `__cuda_array_interface__` bytes."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def unowned(t):
    """A view of t's memory (same shape, strides and dtype) that does not
    keep t's storage allocated; anything but a tensor as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    n = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    raw = torch.as_tensor(_Span(t.data_ptr(), n * t.element_size()),
                          device=t.device)
    return raw.view(t.dtype).as_strided(t.shape, t.stride())


def _attention(*args, **kwargs):
    """The attention entry as `layers` names it at the time of the call."""
    return layers.attention(*args, **kwargs)


@contextlib.contextmanager
def _cutting(recorder):
    """In this block, on this thread, hand every call of `layers.attention`
    and every `GroupNormSiLU` call to `recorder.cut(slot, call, replay,
    args, kwargs)`: `slot` is a new tensor shaped, laid out and typed as
    the call's output (K3/K4's (B, Sq, H, d) memory viewed as (B, H, Sq,
    d); K6's contiguous output), `call` runs it now, `replay` runs it at a
    replay. Other threads' calls run as they are."""
    thread = threading.get_ident()
    entry = layers.attention
    module_call = torch.nn.Module.__call__

    def attention(q, k, v, extra_k=None, extra_v=None):
        kw = {"extra_k": extra_k, "extra_v": extra_v}
        if threading.get_ident() != thread:
            return entry(q, k, v, **kw)
        B, H, sq, _ = q.shape
        slot = torch.empty((B, sq, H, v.shape[-1]), dtype=q.dtype,
                           device=q.device).permute(0, 2, 1, 3)
        return recorder.cut(slot, entry, _attention, (q, k, v), kw)

    def groupnorm(mod, x):
        if threading.get_ident() != thread:
            return module_call(mod, x)
        slot = torch.empty(x.shape, dtype=mod.out_dtype or x.dtype,
                           device=x.device)
        return recorder.cut(slot, lambda x: module_call(mod, x), mod, (x,),
                            {})

    layers.attention = attention
    GroupNormSiLU.__call__ = groupnorm
    try:
        yield
    finally:
        layers.attention = entry
        del GroupNormSiLU.__call__


class _Recorder:
    """The capture of one call, cut at each attention and GroupNorm call."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.cuts: List[tuple] = []
        self.open: Optional[torch.cuda.CUDAGraph] = None

    def begin(self):
        self.open = torch.cuda.CUDAGraph()
        # thread-local: another thread (the paint loop's image writer) may
        # wait on its own events while this one captures
        self.open.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")

    def end(self):
        g, self.open = self.open, None
        g.capture_end()
        self.graphs.append(g)
        g.replay()

    def abort(self):
        if self.open is not None:
            g, self.open = self.open, None
            try:
                g.capture_end()
            except RuntimeError:
                pass

    def cut(self, slot, call, replay, args, kwargs):
        """End the open graph (`slot` was allocated in it), run
        call(*args, **kwargs) into slot, begin the next graph; record
        replay(*args, **kwargs) into slot for the replays."""
        self.end()
        out = call(*args, **kwargs)
        if out.shape != slot.shape or out.dtype != slot.dtype:
            raise RuntimeError(
                f"a cut call returned {tuple(out.shape)} {out.dtype}, its "
                f"slot is {tuple(slot.shape)} {slot.dtype}")
        slot.copy_(out)
        self.cuts.append((replay, [unowned(a) for a in args],
                          {k: unowned(a) for k, a in kwargs.items()},
                          unowned(slot)))
        self.begin()
        return slot


class _Graphs:
    """One captured call: its static inputs, graphs, cut calls and static
    output."""

    def __init__(self, fn: Callable, args: Sequence):
        ambient = torch.cuda.current_stream()
        self.inputs = [None if a is None else a.clone() for a in args]
        stream = _capture_stream(ambient.device)
        stream.wait_stream(ambient)
        rec = _Recorder()
        with torch.cuda.stream(stream):
            try:
                with _cutting(rec):
                    rec.begin()
                    out = fn(*self.inputs)
                    rec.end()
            except BaseException:
                rec.abort()
                raise
        ambient.wait_stream(stream)
        self.output = out
        self.graphs, self.cuts = rec.graphs, rec.cuts

    def static_bytes(self) -> int:
        held = [t for t in self.inputs if t is not None] + [self.output]
        return sum(t.untyped_storage().nbytes() for t in held)

    def replay(self, args: Sequence) -> torch.Tensor:
        for dst, src in zip(self.inputs, args):
            if dst is not None:
                dst.copy_(src)
        for g, (call, a, kw, slot) in zip(self.graphs, self.cuts):
            g.replay()
            slot.copy_(call(*a, **kw))
        self.graphs[-1].replay()
        return self.output


class TeacherGraphs:
    """The teacher's captured calls by key (the tensors' shapes, strides,
    dtypes and devices, plus the caller's `extra`: its int8 flags), and
    counters of what each call did: `counts` (captures, replays, eager
    calls, fallbacks) and `eager` (eager calls by reason)."""

    def __init__(self):
        self._entries: Dict[tuple, object] = {}
        self.counts = dict.fromkeys(("captures", "replays", "eager",
                                     "fallbacks"), 0)
        self.eager: Counter = Counter()

    def __deepcopy__(self, memo):
        # graphs hold the addresses of one teacher's tensors: a copy of the
        # teacher captures its own
        return TeacherGraphs()

    def clear(self) -> None:
        """Drop every graph: the next call of each key runs eagerly."""
        if any(isinstance(e, _Graphs) for e in self._entries.values()):
            torch.cuda.synchronize()
        self._entries.clear()

    def static_bytes(self) -> int:
        """Device bytes the graphs keep allocated between calls."""
        return sum(e.static_bytes() for e in self._entries.values()
                   if isinstance(e, _Graphs))

    def cut_calls(self) -> int:
        """The eager calls between the graphs of each replay, summed over
        the captured keys."""
        return sum(len(e.cuts) for e in self._entries.values()
                   if isinstance(e, _Graphs))

    def stats(self) -> dict:
        return dict(self.counts, eager_by_reason=dict(self.eager),
                    static_bytes=self.static_bytes(),
                    cut_calls=self.cut_calls())

    def _run_eager(self, fn, args, reason):
        self.counts["eager"] += 1
        self.eager[reason] += 1
        with span("teacher.eager"):
            return fn(*args)

    def __call__(self, fn: Callable, args: Sequence, extra: tuple = (),
                 sharded: Callable[[], bool] = lambda: False,
                 bypass: Optional[str] = None) -> torch.Tensor:
        """fn(*args), a tensor, by graphs where the call allows. `args`:
        tensors or None; `sharded()` tells whether the towers are cut by
        tensor_parallel (asked once a key); `bypass`, the caller's reason
        to run eagerly."""
        tensors = [a for a in args if a is not None]
        dev = tensors[0].device
        if bypass is None:
            if not all(a.is_cuda and a.device == dev for a in tensors):
                bypass = "an input off the card"
            elif att._SEQ_PARALLEL["mesh"] is not None:
                bypass = "sequence_parallel"
        if bypass is not None:
            return self._run_eager(fn, args, bypass)
        key = tuple(None if a is None else
                    (tuple(a.shape), a.stride(), a.dtype, a.device)
                    for a in args) + tuple(extra)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = ("tensor_parallel" if sharded()
                                          else FIRST)
            return self._run_eager(fn, args, entry)
        if isinstance(entry, _Graphs):
            self.counts["replays"] += 1
            with span("teacher.replay"):
                return entry.replay(args)
        if entry != FIRST:
            return self._run_eager(fn, args, entry)
        try:
            with span("teacher.capture"):
                graphs = _Graphs(fn, args)
        except Exception as e:  # noqa: BLE001 - any failure falls back
            reason = f"capture failed: {type(e).__name__}: {e}"[:300]
            self._entries[key] = reason
            self.counts["fallbacks"] += 1
            warnings.warn(f"the teacher's call runs eagerly: {reason}")
            return self._run_eager(fn, args, reason)
        self._entries[key] = graphs
        self.counts["captures"] += 1
        return graphs.output
