"""The port's root drivers (generate_survey_textures,
get_texture_renders_cond_grid, run_ablation_study under
contexture_nerf_tpu_torch/) and the rest of its ops/image.py, against the
JAX package's, on the CPU.

The configs each driver composes equal the reference's, field for field,
and the ablation's 16 YAML files load to the same configs. For the PNGs,
`paint` is a no-op on both sides (monkeypatched here only), both runs are
tiny (64 px renders of the torus, a 16-texel lattice) and the port's MLP
is the reference's through the weight bridge: every pixel of every PNG
equals the reference's within one level of 255 (two frameworks' f32
renders and resizes truncated to uint8).

ops/image.py: the pads, kernels, blurs, boxes and crops equal the
reference's to 1e-6 (f32); resize_bilinear to 1e-5, up and down.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import contexture_nerf_tpu.training.trainer as jax_trainer
import generate_survey_textures as j_survey
import get_texture_renders_cond_grid as j_renders
import run_ablation_study as j_ablation
from contexture_nerf_tpu.core.config import config_to_dict as j_to_dict
from contexture_nerf_tpu.ops import image as jimage
from contexture_nerf_tpu_torch import generate_survey_textures as survey
from contexture_nerf_tpu_torch import get_texture_renders_cond_grid as renders
from contexture_nerf_tpu_torch import run_ablation_study as ablation
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import config_to_dict, load_config
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops import image as timage
from contexture_nerf_tpu_torch.training import trainer as port_trainer

ROOT = Path(__file__).resolve().parent.parent
TORUS = str(ROOT / "shapes" / "torus.obj")
TINY = {"render": {"train_grid_size": 64, "eval_grid_size": 64},
        "guide": {"texture_resolution": 16}}
RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _composed(monkeypatch, port_module, run_ref, run_port):
    """The configs the reference's and the port's run_one hand to
    ConTEXTure (each stopped there)."""
    seen = {}

    def grab(key):
        def init(self, cfg, *a, **k):
            seen[key] = cfg
            raise _Stop
        return init

    monkeypatch.setattr(jax_trainer.ConTEXTure, "__init__", grab("ref"))
    monkeypatch.setattr(port_module.ConTEXTure, "__init__", grab("port"))
    for run in (run_ref, run_port):
        with pytest.raises(_Stop):
            run()
    return seen["ref"], seen["port"]


def test_survey_config_is_the_reference(monkeypatch, tmp_path):
    ref, port = _composed(
        monkeypatch, survey,
        lambda: j_survey.run_one(TORUS, "a photo of a dairy cow", tmp_path),
        lambda: survey.run_one(TORUS, "a photo of a dairy cow", tmp_path))
    assert config_to_dict(port) == j_to_dict(ref)
    assert survey.SURVEY == j_survey.SURVEY
    assert survey.MAX_RETRIES == j_survey.MAX_RETRIES


@pytest.mark.parametrize("pair", [0, 1])
def test_texture_renders_config_is_the_reference(monkeypatch, tmp_path,
                                                 pair):
    p = dict(j_renders.PAIRS[pair], path=TORUS)
    ref, port = _composed(
        monkeypatch, renders,
        lambda: j_renders.run_one(p, p["prompts"][0], tmp_path),
        lambda: renders.run_one(p, p["prompts"][0], tmp_path))
    assert config_to_dict(port) == j_to_dict(ref)
    assert renders.PAIRS == j_renders.PAIRS
    assert renders.CANONICAL_PHIS == j_renders.CANONICAL_PHIS
    for phi in renders.CANONICAL_PHIS:
        assert renders.canonical_theta(phi) == j_renders.canonical_theta(phi)


def test_ablation_yamls_are_the_reference(monkeypatch, tmp_path):
    import subprocess
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref_calls, port_calls = [], []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **k: ref_calls.append(cmd))
    j_ablation.main()
    paths = ablation.main(runner=lambda cmd, **k: port_calls.append(cmd))
    assert len(ref_calls) == len(port_calls) == len(paths) == 16
    for rc, pc in zip(ref_calls, port_calls):
        assert rc[2] == "scripts.run_contexture"
        assert pc[2] == "contexture_nerf_tpu_torch.run_contexture"
        ry = yaml.safe_load(Path(rc[3].split("=", 1)[1]).read_text())
        py = yaml.safe_load(Path(pc[3].split("=", 1)[1]).read_text())
        assert py == ry
        assert config_to_dict(load_config([pc[3]])) == \
            config_to_dict(load_config([rc[3]]))
    # run_one composes the same YAML and loads it as the CLI does
    seen = []
    monkeypatch.setattr(ablation.ConTEXTure, "__init__",
                        lambda self, cfg, **k: seen.append(cfg) or None)
    monkeypatch.setattr(ablation.ConTEXTure, "paint", lambda self: None)
    ablation.run_one(3, 5)
    want = load_config([port_calls[6][3]])
    assert config_to_dict(seen[0]) == config_to_dict(want)


# -- the PNGs, paint a no-op on both sides ------------------------------------------------

def _tiny_reference(monkeypatch, made):
    """The reference's ConTEXTure made tiny, its paint a no-op."""
    base = jax_trainer.ConTEXTure

    class Tiny(base):
        def __init__(self, cfg):
            for section, values in TINY.items():
                for k, v in values.items():
                    setattr(getattr(cfg, section), k, v)
            super().__init__(cfg, tiny_models=True, backend="xla")
            made.append(self)

        def paint(self):
            pass

    monkeypatch.setattr(jax_trainer, "ConTEXTure", Tiny)


def _bridged_mlp(ref_run):
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, ref_run.texture_params)))
    return mlp


def _same_within_one_level(got_dir, ref_dir, names):
    assert names
    for name in names:
        a = np.asarray(Image.open(got_dir / name), np.int16)
        b = np.asarray(Image.open(ref_dir / name), np.int16)
        assert a.shape == b.shape == (320, 320, 3), name
        assert a.max() > 0, name
        assert np.abs(a - b).max() <= 1, (name, np.abs(a - b).max())
        assert (a < 250).mean() > 0.1, name  # the object is in the crop


def test_survey_pngs_are_the_reference(monkeypatch, tmp_path):
    made = []
    _tiny_reference(monkeypatch, made)
    monkeypatch.chdir(tmp_path)
    prompt = "a photo of a dairy cow"
    j_survey.run_one(TORUS, prompt, tmp_path / "ref")
    monkeypatch.setattr(port_trainer.ConTEXTure, "paint", lambda self: None)
    _, written = survey.run_one(TORUS, prompt, tmp_path / "port",
                             overrides=TINY, device="cpu", tiny_models=True,
                             mlp=_bridged_mlp(made[0]))
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in written) == names
    assert len(names) == 7
    _same_within_one_level(tmp_path / "port", tmp_path / "ref", names)


def test_texture_render_pngs_are_the_reference(monkeypatch, tmp_path):
    made = []
    _tiny_reference(monkeypatch, made)
    monkeypatch.chdir(tmp_path)
    pair = dict(j_renders.PAIRS[1], path=TORUS)
    prompt = pair["prompts"][1]
    j_renders.run_one(pair, prompt, tmp_path / "ref")
    monkeypatch.setattr(port_trainer.ConTEXTure, "paint", lambda self: None)
    _, written = renders.run_one(pair, prompt, tmp_path / "port",
                              overrides=TINY, device="cpu",
                              tiny_models=True, mlp=_bridged_mlp(made[0]))
    ref_dir = next((tmp_path / "ref" / "torus").iterdir())
    names = sorted(p.name for p in ref_dir.iterdir())
    assert len(names) == len(written) == 7
    assert written[0].parent.relative_to(tmp_path / "port") == \
        ref_dir.relative_to(tmp_path / "ref")
    _same_within_one_level(written[0].parent, ref_dir, names)


# -- ops/image.py ------------------------------------------------------------------------------

def _close(got, ref, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("hw", [(9, 12), (10, 13)])
def test_pad_tensor_to_size(hw):
    x = RNG.random((2, 3, 7, 8)).astype(np.float32)
    _close(timage.pad_tensor_to_size(torch.from_numpy(x), *hw),
           jimage.pad_tensor_to_size(jnp.asarray(x), *hw))
    _close(timage.pad_tensor_to_size(torch.from_numpy(x), *hw, value=0.5),
           jimage.pad_tensor_to_size(jnp.asarray(x), *hw, value=0.5))


@pytest.mark.parametrize("out", [(7, 5), (40, 52)])
def test_resize_bilinear_down_and_up(out):
    x = RNG.random((1, 3, 21, 26)).astype(np.float32)
    _close(timage.resize_bilinear(torch.from_numpy(x), *out),
           jimage.resize_bilinear(jnp.asarray(x), *out), 1e-5)


def test_gaussian_kernel_blur_and_smooth():
    _close(timage.gaussian_kernel_2d(7, 1.5),
           jimage.gaussian_kernel_2d(7, 1.5))
    x = RNG.random((2, 1, 30, 24)).astype(np.float32)
    _close(timage.gaussian_blur(torch.from_numpy(x), 9, 2.0),
           jimage.gaussian_blur(jnp.asarray(x), 9, 2.0))
    img = RNG.random((3, 40, 33)).astype(np.float32)
    _close(timage.smooth_image(torch.from_numpy(img), 3.0, 11),
           jimage.smooth_image(jnp.asarray(img), 3.0, 11))


def test_boxes_and_crops():
    masks = np.zeros((3, 40, 50), np.float32)
    masks[0, 5:20, 7:30] = 1
    masks[1, 22:39, 1:9] = 1
    masks[2, 0:40, 20:21] = 1
    boxes = timage.get_nonzero_region_vectorized(torch.from_numpy(masks))
    ref = jimage.get_nonzero_region_vectorized(masks)
    assert boxes.dtype == np.int64
    np.testing.assert_array_equal(boxes, ref)
    img = RNG.random((3, 3, 40, 50)).astype(np.float32)
    _close(timage.crop_img_to_bounding_box(torch.from_numpy(img), boxes),
           jimage.crop_img_to_bounding_box(jnp.asarray(img), ref))


def test_seed_everything_seeds_as_the_reference():
    jimage.seed_everything(5)
    a = np.random.random(4)
    timage.seed_everything(5)
    np.testing.assert_array_equal(np.random.random(4), a)
    first = torch.rand(3)
    timage.seed_everything(5)
    assert torch.equal(torch.rand(3), first)
    assert dataclasses.is_dataclass(load_config([]))
