"""optim.tensor_parallel and optim.sequence_parallel in the port: the
reference's `ConTEXTure._make_mesh` refuses both at once, and refuses
either on one device, where no device mesh can be built. The port runs on
one device, so each request raises ValueError before any step, in
`build_models`, `ConTEXTure`, `SDSTrainer`, `paint_zero123plus` and
`evaluate`, as the reference does on one device.
"""

from types import SimpleNamespace

import jax
import pytest

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.training import trainer as tr
from tools.make_shapes import uv_sphere, write_obj

CASES = {"tensor_parallel": ({"tensor_parallel": 2}, "requested"),
         "sequence_parallel": ({"sequence_parallel": 4}, "requested"),
         "both": ({"tensor_parallel": 2, "sequence_parallel": 2},
                  "mutually exclusive")}


def _cfg_dict(tmp_path, knobs):
    write_obj(tmp_path / "s.obj", *uv_sphere(4, 6))
    return {"log": {"exp_root": str(tmp_path / "exp"), "log_images": False},
            "render": {"train_grid_size": 32, "eval_grid_size": 32},
            "guide": {"shape_path": str(tmp_path / "s.obj"),
                      "texture_resolution": 16},
            "optim": dict(knobs)}


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_knobs_raise_as_the_reference_does_on_one_device(
        tmp_path, monkeypatch, case):
    knobs, words = CASES[case]
    d = _cfg_dict(tmp_path, knobs)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax_trainer.jax, "devices", lambda *a: one)
    with pytest.raises(ValueError, match=words) as ref:
        jax_trainer.ConTEXTure._make_mesh(
            SimpleNamespace(cfg=config_from_dict(d)))
    assert "no mesh can be built" in str(ref.value) or case == "both"
    monkeypatch.undo()

    cfg = torch_config_from_dict(d)
    for build in (lambda: tr.build_models(cfg, tiny=True, device="cpu"),
                  lambda: tr.ConTEXTure(cfg, tiny_models=True, device="cpu"),
                  lambda: tr.SDSTrainer(cfg, {}, tiny=True, device="cpu")):
        with pytest.raises(ValueError, match=words) as got:
            build()
        assert "optim.tensor_parallel" in str(got.value)
    if case == "both":
        assert str(got.value) == str(ref.value)
    # a run built with the knobs off refuses them when they are set later,
    # before its first step and before its eval
    run = tr.ConTEXTure(torch_config_from_dict(_cfg_dict(tmp_path, {})),
                        tiny_models=True, device="cpu")
    for k, v in knobs.items():
        setattr(run.cfg.optim, k, v)
    with pytest.raises(ValueError, match=words):
        run.paint_zero123plus()
    with pytest.raises(ValueError, match=words):
        run.evaluate(run.dataloaders["val"], tmp_path / "eval")
    assert not (tmp_path / "eval").exists()
