"""The port's user tools against the JAX package's: `compare_outputs`
(pairing, PSNR, JSON line and exit code, against tools/compare_outputs.py
on the same image pairs) and `knob_quality` (the same paint arguments as
tools/knob_quality.py, and the same `compare` on two tiny runs painted by
the port's CLI, defaults against local_sds_grad + precompute_uv_embedding).
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch.tools import compare_outputs, knob_quality
from tools import compare_outputs as ref_compare
from tools import knob_quality as ref_knobs
from tools.make_shapes import uv_sphere, write_obj


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path, arr):
    Image.fromarray(arr).save(path)


@pytest.fixture
def image_dirs(tmp_path):
    """REF and OUT: an equal pair, a noisy pair, a pair of another size, a
    JPG pair, a file REF has alone and one OUT has alone."""
    rng = np.random.default_rng(0)
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    out.mkdir()
    base = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    _png(ref / "same.png", base)
    _png(out / "same.png", base)
    noisy = np.clip(base.astype(int) + rng.integers(-6, 7, base.shape), 0,
                    255).astype(np.uint8)
    _png(ref / "noisy.png", base)
    _png(out / "noisy.png", noisy)
    _png(ref / "resized.png", base)
    Image.fromarray(base).resize((16, 12)).save(out / "resized.png")
    Image.fromarray(base).save(ref / "frame.jpg")
    Image.fromarray(noisy).save(out / "frame.jpg")
    _png(ref / "ref_only.png", base)
    _png(out / "out_only.png", base)
    return ref, out


@pytest.mark.parametrize("threshold", [None, "10", "45"])
@pytest.mark.parametrize("missing", [False, True])
def test_compare_outputs_matches_the_reference(image_dirs, capsys, threshold,
                                               missing):
    ref, out = image_dirs
    if not missing:
        (ref / "ref_only.png").unlink()
    argv = [str(ref), str(out)] + (["--threshold", threshold]
                                   if threshold else [])
    got_rc = compare_outputs.main(argv)
    got = capsys.readouterr().out.splitlines()
    want_rc = ref_compare.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert got == want and got_rc == want_rc
    summary = json.loads(got[-1])
    assert summary["pairs"] == 4
    assert summary["missing"] == (["ref_only.png"] if missing else [])
    assert got_rc == (0 if not missing and threshold == "10" else 1)
    results, _ = compare_outputs.compare_dirs(ref, out)
    assert results["same.png"] == float("inf")
    want_results, _ = ref_compare.compare_dirs(ref, out)
    assert results == want_results


def test_knob_quality_paints_the_reference_runs(tmp_path, monkeypatch):
    """The four paints (defaults, knobs, embedding alone, seed + 1) with
    the reference's arguments, through the port's CLI module."""
    calls = []  # both tools' subprocess.run, in call order
    monkeypatch.setattr(knob_quality.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    # the reference logs each paint to /tmp/<name>.log: not here
    monkeypatch.setattr(ref_knobs, "open", lambda *a, **k: io.StringIO(),
                        raising=False)
    monkeypatch.setattr(knob_quality, "compare", lambda a, b: {})
    monkeypatch.setattr(ref_knobs, "compare", lambda a, b: {})
    assert knob_quality.main(["--iters", "7", "--exp-root",
                              str(tmp_path / "runs")]) == 0
    assert ref_knobs.main(["--iters", "7", "--out",
                           str(tmp_path / "ref.json")]) == 0
    assert len(calls) == 8
    for cmd, ref_cmd in zip(calls[:4], calls[4:]):
        assert cmd[1:3] == ["-m", "contexture_nerf_tpu_torch.run_contexture"]
        assert ref_cmd[1:3] == ["-m", "scripts.run_contexture"]
        exp_root = f"--log.exp_root={tmp_path / 'runs'}"
        assert cmd[3:] == [ref_cmd[3]] + [exp_root] + ref_cmd[4:]
    assert (tmp_path / "runs" / "knob_quality.json").exists()
    assert "docs" not in str(knob_quality.DEFAULT_ROOT)


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """Two tiny paints by the port's CLI: the defaults, and the knobs."""
    tmp = tmp_path_factory.mktemp("knobs")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    yaml = (Path(__file__).resolve().parent.parent / "configs"
            / "text_guided" / "spot_quick_test.yaml")
    runs = {}
    for name, knobs in (("knobq_default", []),
                        ("knobq_knobs", ["--optim.local_sds_grad=true",
                                         "--optim.precompute_uv_embedding"
                                         "=true"])):
        argv = [f"--config_path={yaml}", f"--guide.shape_path={tmp}/s.obj",
                f"--log.exp_root={tmp}", f"--log.exp_name={name}",
                "--render.train_grid_size=48", "--render.eval_grid_size=48",
                "--guide.texture_resolution=16", "--log.full_eval_size=3",
                "--optim.sds_iterations=2", "--log.log_images=false"] + knobs
        runs[name] = run_contexture.main(argv, device="cpu",
                                         tiny_models=True).exp_path
    return tmp, runs


def test_knob_quality_compare_matches_the_reference(two_runs):
    tmp, runs = two_runs
    a, b = runs["knobq_default"], runs["knobq_knobs"]
    got = knob_quality.compare(a, b)
    assert got == ref_knobs.compare(a, b)
    assert set(got) == {"texture_atlas_psnr_db", "albedo_psnr_db",
                        "eval_render_psnr_db", "sds_loss"}
    assert len(got["eval_render_psnr_db"]["per_frame"]) == 3
    assert got["sds_loss"]["default"]["records"] == 2
    self_cmp = knob_quality.compare(a, a)
    assert self_cmp["texture_atlas_psnr_db"] == float("inf")


def test_knob_quality_compare_only_writes_its_json(two_runs, capsys):
    tmp, runs = two_runs
    out = tmp / "kq.json"
    assert knob_quality.main(["--compare-only", "--iters", "2",
                              "--exp-root", str(tmp), "--out",
                              str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["default_vs_knobs"] == knob_quality.compare(
        runs["knobq_default"], runs["knobq_knobs"])
    # the controls that were not painted are left out, not compared
    assert "default_vs_seed1_chaos_floor" not in result
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
