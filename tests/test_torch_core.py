"""The port's core helpers (contexture_nerf_tpu_torch.core: timing,
profiler, guards, imagewriter, checkpoint) on the CPU: the timings summary
and window helpers against the JAX package's on the same inputs, the
guards, the asynchronous image writer's order, failures and backpressure,
and the checkpoint file's round trip and atomic write.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core import profiler as jprofiler
from contexture_nerf_tpu.core import timing as jtiming
from contexture_nerf_tpu_torch.core import checkpoint as ckpt
from contexture_nerf_tpu_torch.core import guards, profiler, timing
from contexture_nerf_tpu_torch.core.imagewriter import (AsyncImageWriter,
                                                        start_host_copy,
                                                        sync_writer)


def _feed(t):
    for name, dt in (("a", 0.5), ("a", 0.010), ("a", 0.030), ("b", 2.0),
                     ("c", 0.25)):
        t.add(name, dt)
    t.note_window("a", 50, 1.7)
    t.note_window("a", 49, 1.6)
    t.note_window("w", 10, 0.1)
    t.note_window("a", 0, 9.0)  # an empty window is ignored


def test_timings_summary_matches_reference(tmp_path):
    ours, ref = profiler.Timings(), jprofiler.Timings()
    _feed(ours)
    _feed(ref)
    assert ours.summary() == ref.summary()
    ours.dump(tmp_path / "t.json")
    ref.dump(tmp_path / "r.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "r.json").read_text()
    s = ours.summary()["a"]
    assert set(s) == {"first_call_s", "steady_count", "steady_mean_ms",
                      "total_s", "window_iter_ms", "windows"}
    assert s["windows"] == 2 and s["window_iter_ms"] == round(
        1000 * 3.3 / 99, 3)


def test_phase_and_annotate_record_into_timings():
    t = profiler.Timings()
    with profiler.phase("p", t):
        pass
    with profiler.phase("p", t, block=True):
        pass

    @profiler.annotate("f", t)
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    s = t.summary()
    assert s["p"]["steady_count"] == 1 and s["f"]["steady_count"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    profiler.start_trace(str(tmp_path / "tr"))
    with profiler.phase("traced", profiler.Timings()):
        torch.ones(8).sum()
    profiler.stop_trace()
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "traced" in text


def test_timing_windows_match_reference():
    calls = []
    out = timing.timed_windows(lambda: calls.append(1), lambda r: None, 5, 3)
    assert len(out) == 3 and len(calls) == 15
    for samples in ([0.010, 0.012, 0.011], [0.01, 0.02, 0.03, 0.05, 0.04]):
        assert timing.median_iqr_ms(samples) == \
            jtiming.median_iqr_ms(samples)


def test_guards():
    good = {"a": torch.ones(3), "b": [np.zeros(2), (torch.zeros(1),)]}
    guards.check_finite(good)
    bad = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("nan")])]}
    with pytest.raises(ValueError, match=r"x\[leaf 1\]"):
        guards.check_finite(bad, "x")
    x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    assert guards.finite_or_zero(x).tolist() == [1.0, 0.0, 0.0, 0.0]
    guards.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        guards.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


# -- the image writer ---------------------------------------------------------------------

def test_async_writer_keeps_order_and_raises_failures():
    w = AsyncImageWriter(max_pending=2)
    got = []
    for i in range(7):
        w.submit(torch.full((2,), i), lambda a: got.append(int(a[0])))
    w.submit((torch.ones(1), np.zeros(1)), lambda ab: got.append(
        (float(ab[0][0]), float(ab[1][0]))))
    w.flush()
    assert got == list(range(7)) + [(1.0, 0.0)]

    def boom(_):
        raise ValueError("write failed")

    w.submit(torch.zeros(1), boom)
    with pytest.raises(ValueError, match="write failed"):
        w.flush()
    w.close()


def test_sync_writer_writes_inline():
    got = []
    sync_writer().submit((torch.ones(2), np.full(1, 3)),
                         lambda ab: got.append((ab[0].tolist(),
                                                ab[1].tolist())))
    assert got == [([1.0, 1.0], [3])]
    assert start_host_copy(torch.arange(3))().tolist() == [0, 1, 2]


def test_async_writer_under_concurrent_submitters():
    """More submitting threads than cores, a short switch interval: every
    write runs exactly once and each thread's writes stay in order."""
    w = AsyncImageWriter(max_pending=3)
    seen, lock = [], threading.Lock()

    def record(a):
        with lock:
            seen.append((int(a[0]), int(a[1])))

    def submitter(k):
        for i in range(40):
            w.submit(torch.tensor([k, i]), record)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        w.close()
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == 12 * 40 and len(set(seen)) == 12 * 40
    for k in range(12):
        assert [i for kk, i in seen if kk == k] == list(range(40))


# -- checkpoints -------------------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    lin = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(lin.parameters(), lr=1e-3)
    lin(torch.randn(5, 4)).sum().backward()
    opt.step()
    g = torch.Generator().manual_seed(7)
    torch.randn(3, generator=g)
    ckpt.save(tmp_path / "iter_000012", lin.state_dict(),
              opt_state=opt.state_dict(), iteration=12,
              generator_state=g.get_state())
    raw = ckpt.restore(tmp_path / "iter_000012")
    assert raw["iteration"] == 12
    for k, v in lin.state_dict().items():
        assert torch.equal(raw["params"][k], v)
    opt2 = torch.optim.Adam(torch.nn.Linear(4, 3).parameters(), lr=1e-3)
    opt2.load_state_dict(raw["opt_state"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    g2 = torch.Generator()
    g2.set_state(raw["generator"])
    assert torch.equal(torch.randn(4, generator=g), torch.randn(
        4, generator=g2))
    # only the final name is left in the directory
    assert [p.name for p in tmp_path.iterdir()] == ["iter_000012"]


def test_checkpoint_latest_and_older_format(tmp_path):
    assert ckpt.latest_iteration(tmp_path) is None
    for it in (5, 40, 1000):
        ckpt.save(tmp_path / f"iter_{it:06d}", {"w": torch.ones(1) * it},
                  iteration=it)
    (tmp_path / "iter_999999.tmp").write_text("")
    (tmp_path / ".iter_002000.77.tmp").write_text("")
    assert ckpt.latest_iteration(tmp_path) == 1000
    raw = ckpt.restore(tmp_path / "iter_000040")
    assert set(raw) == {"params", "iteration"}
    assert float(raw["params"]["w"]) == 40.0


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails while writing leaves no file under the final name
    and no temporary file, and an earlier checkpoint stays as it was."""
    ckpt.save(tmp_path / "iter_000001", {"w": torch.zeros(2)}, iteration=1)

    def broken(obj, f, *a, **kw):
        with open(f, "wb") as fp:
            fp.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(tmp_path / "iter_000002", {"w": torch.ones(2)},
                  iteration=2)
    monkeypatch.undo()
    assert [p.name for p in tmp_path.iterdir()] == ["iter_000001"]
    assert ckpt.latest_iteration(tmp_path) == 1
