"""The port's config loader and CLI entry (contexture_nerf_tpu_torch.core
.config `load_config`, `dump_config`; contexture_nerf_tpu_torch
.run_contexture) against the JAX package's loader: every shipped YAML with
overrides in both forms gives the same config, a dumped config loads back
equal, and the CLI evaluates (log.eval_only) or paints a shipped config
with tiny models on the CPU.
"""

from pathlib import Path

import pytest
import torch
import yaml

from contexture_nerf_tpu.core.config import config_to_dict as j_to_dict
from contexture_nerf_tpu.core.config import load_config as j_load_config
from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch.core.config import (config_to_dict,
                                                   dump_config, load_config)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs" / "text_guided").glob("*.yaml"))
OVERRIDES = ["--log.exp_name", "cli_run", "--optim.sds_lr=2.0e-05",
             "--render.views_after=[[10, 20], [30, 40]]",
             "--guide.text", "a cat, {} view", "--optim.seed=7",
             "--log.exp_root", "somewhere/else", "--optim.resume"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_load_config_matches_reference(path):
    for argv in ([f"--config_path={path}"],
                 ["--config_path", str(path)] + OVERRIDES):
        assert config_to_dict(load_config(argv)) == \
            j_to_dict(j_load_config(argv)), argv
    cfg = load_config([f"--config_path={path}"] + OVERRIDES)
    assert cfg.optim.sds_lr == 2e-05 and cfg.optim.resume is True
    assert cfg.render.views_after == [[10, 20], [30, 40]]
    assert str(cfg.log.exp_dir) == "somewhere/else/cli_run"


def test_a_float_without_a_dot_is_coerced():
    """PyYAML reads "1e-05" (no dot) as a string. The JAX package's loader
    passes such a string into a float field (its annotations are strings
    there, so its type coercion never matches); the port coerces it by the
    field's resolved type."""
    argv = [f"--config_path={CONFIGS[0]}", "--optim.sds_lr=1e-05",
            "--render.radius", "2", "--guide.guidance_scale_i=3"]
    assert j_load_config(argv).optim.sds_lr == "1e-05"
    cfg = load_config(argv)
    assert cfg.optim.sds_lr == 1e-05 and isinstance(cfg.optim.sds_lr, float)
    assert isinstance(cfg.render.radius, float)
    assert cfg.guide.guidance_scale_i == 3


def test_dump_then_load_round_trips(tmp_path):
    cfg = load_config([f"--config_path={CONFIGS[0]}", "--optim.sds_lr=1e-05",
                       "--optim.sds_eps=1e-15", "--optim.min_timestep=0.02"])
    path = tmp_path / "config.yaml"
    dump_config(cfg, path)
    # PyYAML reads "1e-05" (no dot) as a string: the file must not say that
    raw = yaml.safe_load(path.read_text())
    assert raw["optim"]["sds_lr"] == 1e-05
    assert isinstance(raw["optim"]["sds_lr"], float)
    back = load_config([f"--config_path={path}"])
    assert config_to_dict(back) == config_to_dict(cfg)
    assert back.optim.sds_eps == 1e-15


def test_cli_evaluates_and_paints_a_shipped_config(tmp_path, monkeypatch):
    """spot_quick_test.yaml (shapes/sphere.obj, which carries UVs) at 48^2
    with tiny models: with log.eval_only the entry renders the turntable
    and exports without painting; without it, the entry paints (the paint
    run itself is tests/test_torch_paint_loop.py's)."""
    argv = [f"--config_path={ROOT / 'configs/text_guided/spot_quick_test.yaml'}",
            f"--log.exp_root={tmp_path}", "--render.train_grid_size=48",
            "--render.eval_grid_size=48", "--guide.texture_resolution=16",
            "--log.full_eval_size=2"]
    run = run_contexture.main(argv + ["--log.eval_only=true"], device="cpu",
                              tiny_models=True)
    exp = tmp_path / "spot_quick"
    assert run.exp_path == exp and run.cfg.log.eval_only
    for name in ("config.yaml", "log.txt", "results/eval_texture_atlas.png",
                 "mesh/mesh.obj", "mesh/mesh.mtl", "mesh/albedo.png"):
        assert (exp / name).exists(), name
    assert list((exp / "results").glob("eval_video_all_rendered_rgb_0.*"))
    assert not (exp / "metrics.json").exists()  # nothing was painted
    assert config_to_dict(load_config([f"--config_path={exp / 'config.yaml'}"]
                                      )) == config_to_dict(run.cfg)

    painted = []
    monkeypatch.setattr(run_contexture.ConTEXTure, "paint",
                        lambda self: painted.append(self.cfg.log.exp_name))
    monkeypatch.setattr(run_contexture.ConTEXTure, "full_eval",
                        lambda self: painted.append("eval"))
    run_contexture.main(argv, device="cpu", tiny_models=True)
    assert painted == ["spot_quick"]


def test_cli_names_a_missing_shape(tmp_path):
    with pytest.raises(FileNotFoundError, match="nowhere.obj"):
        run_contexture.main([f"--config_path={CONFIGS[0]}",
                             f"--log.exp_root={tmp_path}",
                             f"--guide.shape_path={tmp_path / 'nowhere.obj'}"],
                            device="cpu", tiny_models=True)
