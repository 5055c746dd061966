"""The port's own spans (`core/profiler.py` `span`, `host_read`) and the
benchmark's readers of them (`portbench/spanread.py`, the `*.sds` metrics
that read program spans).

A tiny SDS step on the CPU, on the default and on the exact path, records
under `torch.profiler` the step's stages, the teacher's three passes and
one host read, the tile index's; with the profiler off no
`record_function` range is opened at all. The readers are held to a
hand-built trace of two steps whose numbers are known, K6's backward on
another thread than the step's; a trace without program spans (a program
that opens none) reads None.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from contexture_nerf_tpu_torch import phase
from contexture_nerf_tpu_torch.core import profiler
from contexture_nerf_tpu_torch.ops import groupnorm as gn
from portbench import harness, spanread, tracekit

STAGES = spanread.STAGES
TEACHER = ("teacher.write", "teacher.control", "teacher.read")
NEW_METRICS = ("render_ms.sds", "encode_ms.sds", "backward_ms.sds",
               "adam_ms.sds", "groupnorm_bwd_ms.sds",
               "groupnorm_host_us.sds", "syncs_per_step.sds")
REPLAY_SHARE = "teacher_replay_share.sds"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["sds_default", "sds_exact"])
def state(request):
    """The benchmark cell's trainer at tiny size on the CPU, no first
    steps."""
    cell = harness.Cell(request.param)
    cell.params = dict(cell.params, check_steps=0)
    return cell.driver().setup(cell, 2 ** 31 + 7, torch, device="cpu",
                               tiny=True)


def _trace(body):
    """body() under the profiler (CPU activity) in `pb.window` and one
    `pb.unit`, reduced by tracekit."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("pb.window"):
            with record_function("pb.unit"):
                body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return tracekit.Trace(events, 1, {}, {}, 1.0)


def _inside(inner, outer):
    return any(a <= x and y <= b for x, y in inner for a, b in outer)


def test_a_step_names_its_stages_and_its_one_sync(state):
    tr = _trace(lambda: state.trainer.step(state.ts[state.it]))
    step = spanread.intervals(tr, "sds.step")
    assert len(step) == 1
    for name in STAGES:
        iv = spanread.intervals(tr, name)
        assert iv and all(_inside([s], step) for s in iv), name
    teacher = spanread.intervals(tr, "sds.teacher")
    for name in TEACHER:
        iv = spanread.intervals(tr, name)
        assert len(iv) == 1 and _inside(iv, teacher), name
    syncs = spanread.intervals(tr, "sync.", prefix=True)
    assert spanread.intervals(tr, "sync.tile_idx") == syncs
    assert len(syncs) == 1 and _inside(syncs,
                                       spanread.intervals(tr, "sds.draw"))
    assert spanread.per_step(tr, "sync.", prefix=True) == 1.0
    # render and encode alternate (canvas, then the slice); never nested
    renders = spanread.intervals(tr, "sds.render")
    encodes = spanread.intervals(tr, "sds.encode")
    assert len(renders) == len(encodes) == (1 if state.exact else 2)
    assert not any(_inside([e], renders) for e in encodes)


def test_no_range_is_opened_with_the_profiler_off(state, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler "
                             "off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiler.span("sds.step") is profiler.span("k6.fwd")
    _, loss, *_ = state.trainer.step(state.ts[state.it])
    assert torch.isfinite(loss)
    assert profiler.host_read(loss, "loss") == float(loss)


def test_host_read_is_int_or_float():
    i = torch.tensor([4])
    f = torch.tensor(2.5, dtype=torch.bfloat16)
    assert profiler.host_read(i, "x") == int(i) == 4
    assert isinstance(profiler.host_read(i, "x"), int)
    assert profiler.host_read(f, "x") == float(f) == 2.5
    assert isinstance(profiler.host_read(f, "x"), float)
    assert profiler.host_read(torch.tensor(True), "x") == 1
    assert profiler.host_read(np.int64(3), "x") == 3
    assert isinstance(profiler.host_read(np.int64(3), "x"), int)
    assert profiler.host_read(np.float32(0.5), "x") == 0.5
    tr = _trace(lambda: (profiler.host_read(i, "tile_idx"),
                         profiler.host_read(4, "given")))
    assert len(spanread.intervals(tr, "sync.tile_idx")) == 1
    assert not spanread.intervals(tr, "sync.given")


def test_package_phase_is_a_span_and_still_timed():
    timings = {}

    def body():
        with phase(timings, "bootstrap_unet", "cpu"):
            torch.ones(4).sum()
        with phase(None, "generate_steps", "cpu"):
            torch.ones(4).sum()

    tr = _trace(body)
    assert len(spanread.intervals(tr, "bootstrap_unet")) == 1
    assert len(spanread.intervals(tr, "generate_steps")) == 1
    assert list(timings) == ["bootstrap_unet"] and timings[
        "bootstrap_unet"] >= 0.0


def test_k6_wrapper_spans(monkeypatch):
    """K6's forward and backward spans, the kernels' launches stood in for
    by their plain versions (a CPU tensor cannot reach the kernels)."""
    monkeypatch.setattr(gn, "_group_norm_silu_kernel",
                        gn.group_norm_silu_plain)
    monkeypatch.setattr(gn, "_group_norm_silu_bwd_kernel",
                        gn.group_norm_silu_bwd_plain)
    x = torch.randn(1, 64, 4, 4, requires_grad=True)
    scale, bias = torch.ones(64), torch.zeros(64)

    def body():
        y = gn._GroupNormSiLUKernel.apply(x, scale, bias, 32, 1e-5, True,
                                          torch.float32)
        y.sum().backward()

    tr = _trace(body)
    assert len(spanread.intervals(tr, "k6.fwd")) == 1
    assert len(spanread.intervals(tr, "k6.bwd")) == 1
    assert x.grad is not None


# -- the readers on a hand-built trace --------------------------------------


def _events(program_spans=True, replay="teacher.replay"):
    """Two steps (pb.unit at 0 and 1000 µs) of known spans and kernels; K6's
    backward and the backward's launches on thread 2 while `sds.backward`
    is open on thread 1. A launch between the steps is no step's. The
    teacher call is a `replay` of its CUDA graphs."""
    ev, corr = [], [0]

    def span(name, a, b, tid=1):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": a, "dur": b - a, "tid": tid})

    def op(name, a, b, tid=1):
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": a,
                   "dur": b - a, "tid": tid})

    def launch(at, dev_us, tid=1):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": at, "dur": 1,
                   "tid": tid, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr[0]}",
                   "ts": at + 2, "dur": dev_us, "tid": 7,
                   "args": {"correlation": corr[0]}})

    span("pb.window", -10, 2000)
    for t in (0, 1000):
        span("pb.unit", t - 5, t + 405)
        op("aten::_local_scalar_dense", t + 5, t + 17)
        if program_spans:
            span("sds.step", t, t + 400)
            span("sds.draw", t + 2, t + 20)
            span("sync.tile_idx", t + 4, t + 18)
            span("sds.render", t + 20, t + 60)
            span("sds.encode", t + 60, t + 100)
            span("k6.fwd", t + 70, t + 80)
            span("k6.fwd", t + 85, t + 97)
            span("sds.render", t + 100, t + 110)
            span("sds.teacher", t + 110, t + 200)
            span(replay, t + 112, t + 198)
            span("teacher.read", t + 140, t + 190)
            span("sds.loss", t + 200, t + 220)
            span("sds.backward", t + 220, t + 300)
            span("k6.bwd", t + 240, t + 260, tid=2)
            span("sds.adam", t + 300, t + 320)
            span("sds.out", t + 320, t + 390)
        launch(t + 30, 5)  # render
        launch(t + 62, 10)  # encode
        launch(t + 75, 3)  # encode, K6
        launch(t + 90, 4)  # encode, K6
        launch(t + 105, 2)  # the slice's render
        launch(t + 150, 40)  # teacher
        launch(t + 210, 1)  # loss
        launch(t + 230, 20, tid=2)  # backward
        launch(t + 250, 6, tid=2)  # backward, K6
        launch(t + 310, 2)  # adam
        launch(t + 330, 3)  # out
        launch(t + 395, 1)  # the step, outside its stages
        launch(t + 450, 100)  # between the steps
    return ev


def _read(trace):
    cell = harness.Cell("sds_default")
    return {m: cell.reader(m).read(trace) for m in NEW_METRICS}


def test_readers_on_a_hand_built_trace():
    tr = tracekit.Trace(_events(), 2, {}, {}, 1.0)
    got = _read(tr)
    want = {"render_ms.sds": 0.007, "encode_ms.sds": 0.017,
            "backward_ms.sds": 0.026, "adam_ms.sds": 0.002,
            "groupnorm_bwd_ms.sds": 0.006, "groupnorm_host_us.sds": 11.0,
            "syncs_per_step.sds": 1.0}
    assert got == pytest.approx(want)
    assert spanread.stage_coverage(tr) == pytest.approx((192.0, 194.0))
    assert spanread.device_ms(tr, "teacher.read") == pytest.approx(0.04)
    assert spanread.per_step(tr, "aten::_local_scalar_dense") == 1.0


def test_readers_without_program_spans_read_none():
    tr = tracekit.Trace(_events(program_spans=False), 2, {}, {}, 1.0)
    assert set(_read(tr).values()) == {None}
    assert spanread.stage_coverage(tr) == (0.0, 194.0)


@pytest.mark.parametrize("span,want", [("teacher.replay", 100.0),
                                       ("teacher.capture", 0.0),
                                       ("teacher.eager", 0.0),
                                       ("teacher.other", None)])
def test_the_replay_share_on_a_hand_built_trace(span, want):
    """`teacher_replay_share.sds`: the steps' `teacher.replay` spans over
    their `sds.teacher` spans; None in a trace of a program that opens
    none of the teacher's replay, capture and eager spans."""
    read = harness.Cell("sds_default").reader(REPLAY_SHARE).read
    got = read(tracekit.Trace(_events(replay=span), 2, {}, {}, 1.0))
    assert got == want
    assert read(tracekit.Trace(_events(program_spans=False), 2, {}, {},
                               1.0)) is None


def test_a_tiny_step_on_the_cpu_reads_no_replay(state):
    """A step on the CPU opens `teacher.eager` once inside `sds.teacher`:
    the share reads 0."""
    tr = _trace(lambda: state.trainer.step(state.ts[state.it]))
    eager = spanread.intervals(tr, "teacher.eager")
    assert len(eager) == 1 and _inside(eager,
                                       spanread.intervals(tr, "sds.teacher"))
    assert harness.Cell("sds_default").reader(REPLAY_SHARE).read(tr) == 0.0


def test_the_new_metrics_are_in_the_benchmark():
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in NEW_METRICS:
        m = entries[name]
        assert m["workloads"] == ["sds_default", "sds_exact"]
        assert m["source"] == "device_trace" and m["moves"] == "sds_step_ms"
    # appended together, in this order; entries appended later follow them
    names = [m["name"] for m in b["per_layer"]]
    i = names.index(NEW_METRICS[0])
    assert names[i:i + 7] == list(NEW_METRICS)
    m = entries[REPLAY_SHARE]
    assert (m["layer"], m["moves"], m["better"], m["unit"]) == (
        "teacher", "sds_step_ms", "higher", "%")
    assert m["workloads"] == ["sds_default", "sds_exact"]
