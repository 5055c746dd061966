"""The port's paint run (contexture_nerf_tpu_torch.training.trainer
`ConTEXTure`) on the CPU with tiny models on a procedural UV sphere: what it
writes (the files the reference's tests/test_e2e.py `test_full_pipeline_tiny`
asserts), its metric entries, its cadences against the reference's rules,
and a resumed run against the uninterrupted one (`torch.equal` on every
parameter and on the last iteration's metrics; the reference's
`test_resume_matches_uninterrupted` holds its own at rtol 1e-6).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from contexture_nerf_tpu_torch.core import checkpoint as ckpt
from contexture_nerf_tpu_torch.core import profiler
from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.training import trainer as tr
from tools.make_shapes import uv_sphere, write_obj

ITERS = 4
KEYS = {"iter", "sds_loss", "grad_norm", "fisher_divergence_t",
        "ikl_running_avg", "t", "elapsed_s"}  # reference trainer.py:1114-1119


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(root: Path, shape: str, **optim):
    return config_from_dict({
        "log": {"exp_name": "paint", "exp_root": str(root), "eval_size": 2,
                "full_eval_size": 2},
        "render": {"train_grid_size": 48, "eval_grid_size": 48},
        "guide": {"text": "a tiny test prompt", "shape_path": shape,
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": ITERS,
                  "checkpoint_interval": 2, **optim}})


def _state(t):
    return {k: v.clone() for k, v in t.mlp.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 4-iteration run, then the same run resumed after
    its final checkpoint was deleted."""
    d = tmp_path_factory.mktemp("paint")
    shape = str(d / "sphere.obj")
    write_obj(shape, *uv_sphere(8, 12))
    cfg = _cfg(d / "exp", shape)
    # timings are process-wide (as in the reference): start this run's
    # from nothing, whatever ran earlier in this process
    profiler.GLOBAL_TIMINGS = profiler.Timings()
    a = tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
    before = _state(a)
    a.paint()
    exp = Path(cfg.log.exp_dir)
    listing = sorted(str(p.relative_to(exp)) for p in exp.rglob("*"))
    metrics_a = json.loads((exp / "metrics.json").read_text())
    timings = json.loads((exp / "timings.json").read_text())
    params_a = _state(a)
    ts = [int(t) for t in a.sds.t_schedule(ITERS).tolist()]

    (exp / "checkpoints" / f"iter_{ITERS:06d}").unlink()
    cfg.optim.resume = True
    b = tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
    b.paint()
    metrics_b = json.loads((exp / "metrics.json").read_text())
    return {"exp": exp, "listing": listing, "before": before,
            "a": params_a, "b": _state(b), "metrics_a": metrics_a,
            "metrics_b": metrics_b, "timings": timings, "ts": ts,
            "shape": shape, "root": d}


def test_paint_writes_what_the_reference_writes(runs):
    exp, files = runs["exp"], runs["listing"]
    for name in ("config.yaml", "metrics.json", "timings.json", "log.txt",
                 "mesh/mesh.obj", "mesh/mesh.mtl", "mesh/albedo.png",
                 "results/eval_texture_atlas.png",
                 "checkpoints/iter_000002", "checkpoints/iter_000004",
                 "vis/train/texture_map_iter_000000.png",
                 "vis/train/debug_rendered_grid_clean_0.jpg"):
        assert name in files, name
    assert [f for f in files if f.startswith("results/eval_video_all_"
                                             "rendered_rgb_0.")]
    # nothing half-written is left beside the checkpoints
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == \
        ["iter_000002", "iter_000004"]
    moved = sum(float((runs["a"][k] - runs["before"][k]).abs().sum())
                for k in runs["a"])
    assert np.isfinite(moved) and moved > 0


def test_metric_entries_are_the_references(runs):
    m = runs["metrics_a"]
    assert [e["iter"] for e in m] == [0, ITERS - 1]
    for e in m:
        assert set(e) == KEYS | {"view_consistency"}
        assert all(np.isfinite(v) for v in e.values())
        assert 0.0 < e["view_consistency"] <= 1.0
    # the running average of the Fisher divergence: 0.99/0.01 from the
    # first logged value on
    avg = m[0]["fisher_divergence_t"]
    assert m[0]["ikl_running_avg"] == avg
    for e in m[1:]:
        avg = 0.99 * avg + 0.01 * e["fisher_divergence_t"]
        assert e["ikl_running_avg"] == avg
    assert [e["t"] for e in m] == [runs["ts"][0], runs["ts"][-1]]
    t = runs["timings"]
    assert t["sds_step"]["window_iter_ms"] > 0
    assert t["sds_step"]["windows"] == 1
    for k in ("first_call_s", "steady_count", "steady_mean_ms", "total_s"):
        assert k in t["sds_step"] and k in t["eval"] and k in t["export"]
    assert "view_consistency_metric" in t


def test_resume_matches_the_uninterrupted_run(runs):
    a, b = runs["a"], runs["b"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    last_a = [e for e in runs["metrics_a"] if e["iter"] == ITERS - 1][0]
    last_b = [e for e in runs["metrics_b"] if e["iter"] == ITERS - 1][0]
    for k in ("sds_loss", "grad_norm", "fisher_divergence_t", "t",
              "view_consistency"):
        assert last_a[k] == last_b[k], k
    # as in the reference (trainer.py:1076), the running average starts
    # again at the first entry after a resume
    assert last_b["ikl_running_avg"] == last_b["fisher_divergence_t"]
    # the history from before the checkpoint is kept
    assert runs["metrics_b"][0] == runs["metrics_a"][0]
    assert "Resumed from checkpoint iter 2" in \
        (runs["exp"] / "log.txt").read_text()


def test_resume_from_a_params_only_checkpoint(runs, tmp_path):
    """A checkpoint of the older format (params and iteration only)
    restores: the run continues from its iteration with fresh Adam state."""
    cfg = _cfg(tmp_path, runs["shape"], sds_iterations=3, resume=True)
    cfg.log.save_mesh = False
    cfg.log.log_images = False
    t = tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
    ckpt.save(t.ckpt_path / "iter_000002", runs["a"], iteration=2)
    assert ckpt.latest_iteration(t.ckpt_path) == 2
    t.paint()  # runs iteration 2 only
    m = json.loads((Path(cfg.log.exp_dir) / "metrics.json").read_text())
    assert [e["iter"] for e in m] == [2]
    assert ckpt.restore(t.ckpt_path / "iter_000003")["iteration"] == 3


@pytest.mark.parametrize("iterations,interval", [(1201, 1000), (5000, 250),
                                                  (37, 5), (4, 0)])
def test_cadences_are_the_references(iterations, interval):
    """The loop's rules at iterations 0..1200, written out as the
    reference's loop states them (contexture_nerf_tpu/training/trainer.py
    :1101, :1120, :1140, :1147)."""
    for i in range(min(iterations, 1201)):
        last = i == iterations - 1
        assert tr.logs_metrics(i, iterations) == (i % 50 == 0 or last)
        assert tr.logs_view_consistency(i, iterations) == \
            (i % 250 == 0 or last)
        assert tr.logs_images(i) == \
            ((i % 10 == 0 and i < 1000) or i % 100 == 0)
        assert tr.saves_checkpoint(i, iterations, interval) == (
            interval > 0 and (i + 1) % interval == 0
            and (i + 1) < iterations)


def test_paint_refuses_the_path_without_zero123plus(runs, tmp_path):
    cfg = _cfg(tmp_path, runs["shape"])
    cfg.guide.use_zero123plus = False
    t = tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
    with pytest.raises(ValueError, match="use_zero123plus=False"):
        t.paint()


def test_a_missing_shape_is_named(tmp_path):
    cfg = _cfg(tmp_path, str(tmp_path / "no_such.obj"))
    with pytest.raises(FileNotFoundError, match="no_such.obj"):
        tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
