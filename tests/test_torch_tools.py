"""The port's user tools against the JAX package's: `compare_outputs`
(pairing, PSNR, JSON line and exit code, against tools/compare_outputs.py
on the same image pairs) and `knob_quality` (the paint arguments of
tools/knob_quality.py but for the knob flags, which each run of the port's
tool names, and the same `compare` on two tiny runs painted by the port's
CLI, the reference-exact defaults against local_sds_grad +
precompute_uv_embedding).
"""

import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch.core.config import load_config
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


# the knob flags each run of the port's tool passes, in order; the
# reference's passes none for the defaults (so under the config's defaults
# its two runs take one path) and the embedding alone for emb_only
KNOB_FLAGS = {
    "knobq_default": ["--optim.local_sds_grad=false",
                      "--optim.precompute_uv_embedding=false"],
    "knobq_knobs": ["--optim.local_sds_grad=true",
                    "--optim.precompute_uv_embedding=true"],
    "knobq_emb_only": ["--optim.local_sds_grad=false",
                       "--optim.precompute_uv_embedding=true"],
    "knobq_seed1": ["--optim.local_sds_grad=false",
                    "--optim.precompute_uv_embedding=false"],
}
# (local_sds_grad, precompute_uv_embedding) each run resolves to
RESOLVED = {"knobq_default": (False, False), "knobq_knobs": (True, True),
            "knobq_emb_only": (False, True), "knobq_seed1": (False, False)}


def _is_knob_flag(arg):
    return arg.startswith(("--optim.local_sds_grad=",
                           "--optim.precompute_uv_embedding="))


def _paint_commands(tmp_path, monkeypatch):
    """{run: (the port's command, the reference's command)} of the four
    paints (defaults, knobs, embedding alone, seed + 1), both tools run
    with their subprocesses recorded."""
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
    assert (tmp_path / "runs" / "knob_quality.json").exists()
    return {next(a for a in cmd if a.startswith("--log.exp_name="))
            .split("=", 1)[1]: (cmd, ref_cmd)
            for cmd, ref_cmd in zip(calls[:4], calls[4:])}


def test_knob_quality_paints_the_reference_runs(tmp_path, monkeypatch):
    """The four paints with the reference's arguments, through the port's
    CLI module, but for the knob flags: the port's names both knobs in
    every run, the reference's none in its defaults."""
    cmds = _paint_commands(tmp_path, monkeypatch)
    assert list(cmds) == list(KNOB_FLAGS)
    for name, (cmd, ref_cmd) in cmds.items():
        assert cmd[1:3] == ["-m", "contexture_nerf_tpu_torch.run_contexture"]
        assert ref_cmd[1:3] == ["-m", "scripts.run_contexture"]
        exp_root = f"--log.exp_root={tmp_path / 'runs'}"
        rest = [a for a in cmd[3:] if not _is_knob_flag(a)]
        ref_rest = [a for a in ref_cmd[3:] if not _is_knob_flag(a)]
        assert rest == [ref_rest[0]] + [exp_root] + ref_rest[1:]
        assert [a for a in cmd if _is_knob_flag(a)] == KNOB_FLAGS[name]
    assert [a for a in cmds["knobq_default"][1] if _is_knob_flag(a)] == []
    assert "docs" not in str(knob_quality.DEFAULT_ROOT)


@pytest.mark.parametrize("name", list(RESOLVED))
def test_knob_quality_runs_resolve_their_knobs(tmp_path, monkeypatch, name):
    """Each paint's arguments through the port's CLI config loader (from
    the repository root, as the tool runs them) give the run's knobs."""
    cmd, _ = _paint_commands(tmp_path, monkeypatch)[name]
    monkeypatch.chdir(knob_quality.REPO)
    opt = load_config(cmd[3:]).optim
    assert (opt.local_sds_grad, opt.precompute_uv_embedding) == \
        RESOLVED[name]


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """Two tiny paints by the port's CLI: the reference-exact defaults
    (both knobs false), and the knobs. The margin of 8 px keeps the local
    backward's slice (32 + 2 x 8 px) inside the 96x64 canvas; the default
    64 px would make it the whole canvas."""
    tmp = tmp_path_factory.mktemp("knobs")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    yaml = (Path(__file__).resolve().parent.parent / "configs"
            / "text_guided" / "spot_quick_test.yaml")
    runs, mlps = {}, {}
    for name in ("knobq_default", "knobq_knobs"):
        argv = [f"--config_path={yaml}", f"--guide.shape_path={tmp}/s.obj",
                f"--log.exp_root={tmp}", f"--log.exp_name={name}",
                "--render.train_grid_size=48", "--render.eval_grid_size=48",
                "--guide.texture_resolution=16", "--log.full_eval_size=3",
                "--optim.sds_iterations=2", "--log.log_images=false",
                "--optim.local_sds_margin_px=8"] + KNOB_FLAGS[name]
        run = run_contexture.main(argv, device="cpu", tiny_models=True)
        runs[name] = run.exp_path
        mlps[name] = {k: v.detach().clone()
                      for k, v in run.mlp.state_dict().items()}
    return tmp, runs, mlps


def test_knob_quality_default_and_knobs_runs_differ(two_runs):
    """The two runs' configs differ in the two knobs alone, and the runs
    took two paths: their MLPs or their atlases differ."""
    _, runs, mlps = two_runs
    a, b = runs["knobq_default"], runs["knobq_knobs"]
    assert knob_quality.config_diff(a, b) == {
        "optim.local_sds_grad": (False, True),
        "optim.precompute_uv_embedding": (False, True)}
    assert knob_quality.resolved_knobs(a) == dict(
        zip(knob_quality.KNOBS, RESOLVED["knobq_default"]))
    assert knob_quality.resolved_knobs(b) == dict(
        zip(knob_quality.KNOBS, RESOLVED["knobq_knobs"]))
    mlp_a, mlp_b = mlps["knobq_default"], mlps["knobq_knobs"]
    assert mlp_a.keys() == mlp_b.keys()
    params_differ = any(not torch.equal(mlp_a[k], mlp_b[k]) for k in mlp_a)
    atlas_psnr = knob_quality.compare(a, b)["texture_atlas_psnr_db"]
    assert params_differ or np.isfinite(atlas_psnr)


def test_knob_quality_refuses_a_run_against_itself(two_runs, tmp_path,
                                                   capsys):
    """--compare-only over runs whose knobs run is a copy of the defaults
    run (the reference tool's comparison under the config's defaults)
    exits 1 and names both runs; the same root with the two real runs
    exits 0."""
    _, runs, _ = two_runs
    for name in ("knobq_default", "knobq_knobs"):
        shutil.copytree(runs["knobq_default"], tmp_path / name)
    assert knob_quality.main(["--compare-only", "--iters", "2",
                              "--exp-root", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "knobq_default" in err and "knobq_knobs" in err
    shutil.rmtree(tmp_path / "knobq_knobs")
    shutil.copytree(runs["knobq_knobs"], tmp_path / "knobq_knobs")
    assert knob_quality.main(["--compare-only", "--iters", "2",
                              "--exp-root", str(tmp_path)]) == 0


def test_knob_quality_compare_matches_the_reference(two_runs):
    tmp, runs, _ = two_runs
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
    tmp, runs, _ = two_runs
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
