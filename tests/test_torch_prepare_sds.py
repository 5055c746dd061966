"""The port's prepare_sds (contexture_nerf_tpu_torch.training.trainer)
against the JAX reference's `ConTEXTure.prepare_sds`, tiny models, f32, on
the CPU, on a UV sphere: without the bootstrap (skip_bootstrap=True), then
one SDS step of each on its own setup; and with the SD2-depth front-view
bootstrap, the whole slice as the reference's paint loop runs it.

One tiny JAX trainer, with its SD2-depth towers, is built per module and
runs prepare_sds without the bootstrap (once per tile weighting), then
with it, its SD2-depth weights perturbed off the init. The port gets the
reference's MLP, VAE, CLIP and SD2-depth weights through weights.py, the
two VAE posterior draws of the conditioning re-derived with jax.random from
the reference's key, and the bootstrap's four draws from
PRNGKey(optim.seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.training.trainer import ConTEXTure
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion.sd_depth import (DRAWS,
                                                          StableDiffusionDepth)
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.training.trainer import (
    build_sds_trainer, define_view_weights, prepare_sds, tile_probabilities)
from tools.make_shapes import uv_sphere, write_obj

T = 500
KEY = 3
MODES = ("uniform", "weighted", "mixed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(tmp, mode="uniform"):
    return {
        "log": {"exp_name": "torch_prep", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "a photo of a dairy cow",
                  "shape_path": str(tmp / "s.obj"),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": 1, "tile_weighting": mode,
                  "local_sds_margin_px": 8,
                  "precompute_uv_embedding": False},
    }


def _eps(key, shape):
    """The draws of the reference's prepare_sds -> prepare_conditioning
    -> encode_condition_image (positive, negative)."""
    _, k_cond = jax.random.split(key)
    k1, k2 = jax.random.split(k_cond)
    return tuple(torch.from_numpy(np.asarray(jax.random.normal(k, shape)))
                 for k in (k1, k2))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_prep")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    tr = ConTEXTure(config_from_dict(_cfg_dict(tmp)), tiny_models=True,
                    backend="xla")
    runs = {}
    for mode in MODES:
        tr.cfg.optim.tile_weighting = mode
        key = tr.key
        runs[mode] = (key, tr.prepare_sds(skip_bootstrap=True))
    return tmp, tr, runs


def _port_parts(tr):
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher,
                         jax.tree.map(np.asarray, tr.zero123plus.params))
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    return teacher, mlp


@pytest.fixture(scope="module")
def port(reference):
    tmp, tr, runs = reference
    teacher, mlp = _port_parts(tr)
    key, ref = runs["uniform"]
    cfg = torch_config_from_dict(_cfg_dict(tmp))
    eps = _eps(key, (1,) + tuple(ref["cond_lat_pair"].shape[1:]))
    trainer, setup = build_sds_trainer(cfg, tiny=True, device="cpu",
                                       teacher=teacher, mlp=mlp, eps=eps,
                                       skip_bootstrap=True)
    return trainer, setup


def _close(got, ref, atol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0, err_msg=name)


def test_prepare_sds_matches_reference(reference, port):
    _, _, runs = reference
    _, ref = runs["uniform"]
    _, setup = port
    assert setup["bboxes6"] == [tuple(b) for b in ref["bboxes6"]]
    # f32 throughout; measured errors in brackets. The rasterized faces
    # agree pixel for pixel here (no pixel centre sits within rounding of an
    # edge), so the mask grid is exact and the UVs and the condition image
    # differ only by the camera math's, the MLP's and the resizes' rounding
    # (7e-6); the per-view depth normalization divides by the sphere's z
    # range and so multiplies that rounding (1.4e-5); the VAE and CLIP sum
    # their convolutions and matmuls in other orders (4e-5 of max 5.2, and
    # 4e-6)
    _close(setup["mask_grid"], ref["mask_grid"], 1e-6, "mask_grid")
    _close(setup["depth_grid"], ref["depth_grid"], 5e-5, "depth_grid")
    _close(setup["uv_grid_pts"], ref["uv_grid_pts"], 2e-5, "uv_grid_pts")
    _close(setup["cond_image"], ref["cond_image"], 2e-5, "cond_image")
    _close(setup["cond_lat_pair"], ref["cond_lat_pair"], 2e-4,
           "cond_lat_pair")
    _close(setup["encoder_hidden_states"], ref["encoder_hidden_states"],
           2e-5, "encoder_hidden_states")
    assert float(setup["mask_grid"].max()) > 0.5  # the sphere is in view


@pytest.mark.parametrize("mode", MODES)
def test_tile_probs_match_reference(reference, mode):
    tmp, tr, runs = reference
    _, ref = runs[mode]
    cfg = torch_config_from_dict(_cfg_dict(tmp, mode))
    mesh_model = TexturedMeshModel(cfg.guide, render_grid_size=32,
                                   texture_resolution=16, device="cpu")
    cache, view_weights = define_view_weights(mesh_model, cfg.render)
    probs = tile_probabilities(cache.mask, view_weights, mode)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref["tile_probs"]),
                               atol=1e-7, rtol=0)
    if mode != "uniform":  # the sphere's views are not all alike
        assert float(probs.max() - probs.min()) > 1e-3
    # no best-view pixel anywhere: every mode falls back to uniform, as the
    # reference's w6.sum() <= 0 branch does
    none = tile_probabilities(cache.mask, torch.zeros_like(view_weights),
                              mode)
    np.testing.assert_allclose(none.numpy(), np.full(6, 1 / 6), atol=1e-7)


def test_tile_probs_fallback_matches_reference(reference):
    """The reference with every view weight False (its all-zero branch)."""
    tmp, tr, _ = reference
    mp = pytest.MonkeyPatch()
    orig = tr.define_view_weights

    def no_best_view():
        orig()
        tr.view_weights = jnp.zeros_like(tr.view_weights)

    mp.setattr(tr, "define_view_weights", no_best_view)
    try:
        tr.cfg.optim.tile_weighting = "weighted"
        ref = tr.prepare_sds(skip_bootstrap=True)
    finally:
        mp.undo()
    cfg = torch_config_from_dict(_cfg_dict(tmp, "weighted"))
    mesh_model = TexturedMeshModel(cfg.guide, render_grid_size=32,
                                   texture_resolution=16, device="cpu")
    cache, view_weights = define_view_weights(mesh_model, cfg.render)
    probs = tile_probabilities(cache.mask, torch.zeros_like(view_weights),
                               "weighted")
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref["tile_probs"]),
                               atol=1e-7, rtol=0)


def _draws(tile_probs, z_shape, cl_shape):
    """The step's draws, as sds_step and _cfg_core take them from the key."""
    k_enc, k_noise, k_teach, k_tile = jax.random.split(
        jax.random.PRNGKey(KEY), 4)
    k_neg, k_cond = jax.random.split(k_teach)
    return {
        "tile_idx": int(jax.random.choice(k_tile, 6, p=tile_probs)),
        "eps": np.asarray(jax.random.normal(k_enc, z_shape, jnp.float32)),
        "noise": np.asarray(jax.random.normal(k_noise, z_shape)),
        "neg_noise": np.asarray(jax.random.normal(k_neg, cl_shape)),
        "cond_noise": np.asarray(jax.random.normal(k_cond, cl_shape)),
    }


def test_sds_step_on_ported_setup_matches_reference(reference, port):
    _, tr, runs = reference
    _, ref = runs["uniform"]
    trainer, _ = port
    tr.cfg.optim.tile_weighting = "uniform"
    step, optimizer, hot = tr._build_sds_step(ref, None)
    params = tr.texture_params
    p_ref, _, loss_ref, gn_ref, fisher_ref, grid_ref = step(
        params, optimizer.init(params), jnp.asarray([T], jnp.int32),
        jax.random.PRNGKey(KEY), hot)
    draws = _draws(hot["tile_probs"], trainer.latent_shape(),
                   tuple(hot["cond_lat_pair"].shape[1:]))
    _, loss, gn, fisher, grid = trainer.step(T, draws)
    # each side on its own setup, which differ as bounded above: the
    # MLP's Fourier embedding (top frequency 2^9) turns the UVs' 7e-6 into
    # up to 6e-4 on the composited grid, and the teacher's CFG at 10
    # amplifies the conditioning's differences (measured: loss 1e-7, grad
    # norm 1.2e-4, fisher 1e-6 relative)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(gn_ref), rtol=2e-3)
    np.testing.assert_allclose(float(fisher), float(fisher_ref), rtol=1e-4)
    _close(grid, grid_ref, 2e-3, "grid")


def _perturbed(tree, seed=0):
    """Every leaf moved off its init (norm scales off 1, biases off 0)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(int(np.prod(x.shape[:-1])))
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def bootstrapped(reference):
    """The reference's prepare_sds() with the 50-step bootstrap, as its paint
    loop calls it, after the skip_bootstrap runs."""
    tmp, tr, _ = reference
    tr.cfg.optim.tile_weighting = "uniform"
    tr.diffusion.params = jax.tree.map(jnp.asarray,
                                       _perturbed(tr.diffusion.params, 7))
    # the text pairs from the perturbed text tower, as __init__ makes them
    tr.text_z, tr.text_string = tr._calc_text_embeddings()
    key = tr.key
    return tmp, tr, key, tr.prepare_sds()


def test_prepare_sds_with_bootstrap_matches_reference(reference,
                                                      bootstrapped):
    """The whole slice, and every GroupNorm input of it and of one SDS step
    contiguous: K6 takes contiguous NCHW x only and raises otherwise, which
    the CPU path does not enforce (a permuted view carries its layout
    through the convolutions). The GroupNorm calls of prepare_sds are the
    ones its K6 launches are derived from."""
    tmp, tr, key, ref = bootstrapped
    teacher, mlp = _port_parts(tr)
    sd = StableDiffusionDepth(tiny=True, device="cpu")
    weights.load_sd_depth(sd, jax.tree.map(np.asarray, tr.diffusion.params))
    seen = []
    for m in (teacher, sd):
        for g in m.modules():
            if isinstance(g, GroupNormSiLU):
                g.register_forward_pre_hook(
                    lambda mod, inp: seen.append(inp[0].is_contiguous()))
    cfg = torch_config_from_dict(_cfg_dict(tmp))
    eps = _eps(key, (1,) + tuple(ref["cond_lat_pair"].shape[1:]))
    keys = jax.random.split(jax.random.PRNGKey(cfg.optim.seed), 4)
    draws = {k: torch.from_numpy(np.array(jax.random.normal(
        kk, sd.latent_shape()))) for k, kk in zip(DRAWS, keys)}
    timings = {}
    trainer, setup = build_sds_trainer(cfg, tiny=True, device="cpu",
                                       teacher=teacher, mlp=mlp, eps=eps,
                                       diffusion=sd, bootstrap_draws=draws,
                                       timings=timings)
    assert {"bootstrap_text", "bootstrap_render", "bootstrap_unet",
            "bootstrap_decode", "bootstrap_paste"} <= set(timings)
    # f32 throughout; measured errors in brackets. The bootstrap runs 51
    # UNet steps under CFG at 7.5 and a decode, whose summation-order
    # differences reach the condition image (2.1e-6) and, through the VAE,
    # its latents (2.0e-5 of max 4.8) and the CLIP states (2.8e-6); the
    # geometry is the skip_bootstrap path's, held as tightly as there
    _close(setup["cond_image"], ref["cond_image"], 2e-5, "cond_image")
    _close(setup["cond_lat_pair"], ref["cond_lat_pair"], 2e-4,
           "cond_lat_pair")
    _close(setup["encoder_hidden_states"], ref["encoder_hidden_states"],
           2e-5, "encoder_hidden_states")
    _close(setup["depth_grid"], ref["depth_grid"], 5e-5, "depth_grid")
    _close(setup["mask_grid"], ref["mask_grid"], 1e-6, "mask_grid")
    # the bootstrap changed the condition image: it is not the front render
    no_boot = reference[2]["uniform"][1]["cond_image"]
    assert float(np.abs(np.asarray(setup["cond_image"])
                        - np.asarray(no_boot)).max()) > 1e-2
    n_setup = len(seen)
    trainer.step(T)
    assert n_setup > 1000 and len(seen) > n_setup + 50 and all(seen)


def test_prepare_sds_bootstrap_needs_the_sd2_stack(reference, port):
    tmp, _, _ = reference
    trainer, _ = port
    cfg = torch_config_from_dict(_cfg_dict(tmp))
    mesh_model = TexturedMeshModel(cfg.guide, render_grid_size=32,
                                   texture_resolution=16, device="cpu")
    with pytest.raises(ValueError, match="SD2-depth"):
        prepare_sds(cfg, mesh_model, trainer.mlp, trainer.teacher)


def test_mesh_without_uvs_waits_for_atlas_unwrap(tmp_path, monkeypatch):
    """A mesh without UVs goes through atlas_unwrap: its atlas is the
    reference's unwrap of the normalised mesh (both packages' C++ unwrap,
    as the reference takes it where it builds), the port's numpy path
    equals the reference's numpy path, and it renders."""
    from contexture_nerf_tpu.models import textured_mesh as jtm
    from contexture_nerf_tpu.models.mesh import Mesh as JMesh
    from contexture_nerf_tpu.native import objio
    from contexture_nerf_tpu_torch.models.textured_mesh import atlas_unwrap

    v, f, _, _ = uv_sphere(4, 6)
    write_obj(tmp_path / "nouv.obj", v, f)
    cfg = torch_config_from_dict({"guide": {
        "shape_path": str(tmp_path / "nouv.obj")}})
    mm = TexturedMeshModel(cfg.guide, render_grid_size=32,
                           texture_resolution=16, device="cpu")
    ref_mesh = JMesh.load(str(tmp_path / "nouv.obj")).normalize_mesh(
        target_scale=cfg.guide.shape_scale, dy=cfg.guide.dy)
    vt, ft = jtm.atlas_unwrap(ref_mesh.vertices, ref_mesh.faces)
    np.testing.assert_array_equal(mm.ft, ft)
    np.testing.assert_array_equal(mm.vt, vt)
    monkeypatch.setattr(objio, "chart_unwrap_native", lambda *a, **k: None)
    vt, ft = jtm.atlas_unwrap(ref_mesh.vertices, ref_mesh.faces)
    vt_p, ft_p = atlas_unwrap(mm.mesh.vertices, mm.mesh.faces, native=False)
    np.testing.assert_array_equal(ft_p, ft)
    np.testing.assert_array_equal(vt_p, vt)
    assert mm.face_attributes.shape == (1, f.shape[0], 3, 2)
    cache = mm.render_geometry(theta=[np.pi / 2], phi=[0.0], radius=[2.0])
    assert float(cache.mask.sum()) > 0
    on = cache.mask[0, 0] > 0
    uv = cache.uv_features[0][on]
    assert float(uv.min()) >= 0.0 and float(uv.max()) <= 1.0
