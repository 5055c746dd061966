"""optim.exact_lattice_render in the port (contexture_nerf_tpu_torch
.training.trainer `SDSTrainer.render_grid_latent`'s exact branch,
`prepare_sds`'s cache6) against the JAX reference's `_build_sds_step`,
tiny models, f32, on the CPU: one step's loss, grid and MLP gradients
through the whole texture lattice, the rasterizer's cache of the 6 target
views and the full-canvas backward; local_sds_grad turned off with the
reference's warning; edit_mask_pts None under it, as in the reference.

The reference's gradients are read from its step with optax's Adam
replaced by a transformation that hands the gradients through.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import GuideConfig
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.raster.render import RenderCache
from contexture_nerf_tpu_torch.training import trainer as tr
from tools.make_shapes import uv_sphere, write_obj

T = 500
KEY = 3
RES = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(tmp, **guide):
    return {
        "log": {"exp_name": "torch_exact", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": dict({"text": "torch_exact",
                       "shape_path": str(tmp / "s.obj"),
                       "texture_resolution": RES}, **guide),
        "optim": {"seed": 0, "sds_iterations": 1, "local_sds_grad": True,
                  "local_sds_margin_px": 8, "exact_lattice_render": True},
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_exact")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    jt = jax_trainer.ConTEXTure(config_from_dict(_cfg_dict(tmp)),
                                tiny_models=True, backend="xla")
    setup = jt.prepare_sds(skip_bootstrap=True)
    assert setup["cache6"] is not None and setup["uv_grid_pts"] is None
    return tmp, jt, setup


def _port_mlp(params):
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(jax.tree.map(np.asarray,
                                                          params)))
    return mlp


def _port_mesh_model(tmp):
    return TexturedMeshModel(GuideConfig(shape_path=str(tmp / "s.obj")),
                             render_grid_size=32, texture_resolution=RES,
                             device="cpu")


def _draws(hot, z_shape):
    """The step's draws, as sds_step and _cfg_core take them from the key."""
    k_enc, k_noise, k_teach, k_tile = jax.random.split(
        jax.random.PRNGKey(KEY), 4)
    cl = hot["cond_lat_pair"]
    k_neg, k_cond = jax.random.split(k_teach)
    return {
        "tile_idx": int(jax.random.choice(k_tile, 6, p=hot["tile_probs"])),
        "eps": np.asarray(jax.random.normal(k_enc, z_shape, jnp.float32)),
        "noise": np.asarray(jax.random.normal(k_noise, z_shape)),
        "neg_noise": np.asarray(jax.random.normal(k_neg, cl.shape[1:],
                                                  cl.dtype)),
        "cond_noise": np.asarray(jax.random.normal(k_cond, cl.shape[1:],
                                                   cl.dtype)),
    }


def _port_setup(setup):
    """The reference's setup as the port's SDSTrainer takes it: arrays as
    numpy, cache6 as the port's RenderCache."""
    out = {k: np.asarray(setup[k]) for k in (
        "depth_grid", "cond_lat_pair", "encoder_hidden_states", "tile_probs")}
    out["cache6"] = RenderCache(*(torch.from_numpy(np.array(x))
                                  for x in setup["cache6"]))
    out["bboxes6"] = [tuple(int(v) for v in b) for b in setup["bboxes6"]]
    return out


def test_exact_step_matches_reference(reference, monkeypatch, caplog):
    tmp, jt, setup = reference
    passthrough = optax.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (g, s))
    monkeypatch.setattr(jax_trainer, "optax", SimpleNamespace(
        adam=lambda *a, **k: passthrough,
        apply_updates=lambda p, u: u, global_norm=optax.global_norm))
    step, optimizer, hot = jt._build_sds_step(setup, None)
    params = jt.texture_params
    grads_r, _, loss_r, gn_r, fisher_r, grid_r = step(
        params, optimizer.init(params), jnp.asarray([T], jnp.int32),
        jax.random.PRNGKey(KEY), hot)
    monkeypatch.undo()
    grads_r = weights.convert_tree(jax.tree.map(np.asarray, grads_r))

    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher,
                         jax.tree.map(np.asarray, jt.zero123plus.params))
    with caplog.at_level(logging.WARNING, logger="contexture_nerf_tpu_torch"):
        port = tr.SDSTrainer(torch_config_from_dict(_cfg_dict(tmp)),
                             _port_setup(setup), teacher=teacher,
                             mlp=_port_mlp(params), tiny=True, device="cpu",
                             mesh_model=_port_mesh_model(tmp))
    assert "disabling optim.local_sds_grad" in caplog.text
    assert port.exact and not port.local_grad
    _, loss, gn, fisher, grid = port.step(T, _draws(hot,
                                                    port.latent_shape()))
    # f32 throughout; XLA and torch sum convolutions in other orders
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(gn_r), rtol=1e-3)
    np.testing.assert_allclose(float(fisher), float(fisher_r), rtol=1e-3)
    # the grid is each view cropped and resized to the tile (antialiased),
    # as prepare_sds's depth grid is: the same 5e-5 as that grid's
    # (tests/test_torch_prepare_sds.py)
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_r), atol=5e-5)
    grads = {k: p.grad for k, p in port.mlp.named_parameters()}
    assert set(grads) == set(grads_r)
    for k, v in grads_r.items():
        # each gradient within 2e-3 of its leaf's largest
        scale = float(v.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(),
                                   atol=2e-3 * scale, err_msg=k)


def test_exact_render_keeps_no_edit_mask(reference, tmp_path):
    """Under exact_lattice_render the grid has no UV points, so
    guide.reference_texture's mask reaches no step, as in the reference;
    prepare_sds keeps the 6 target views of its 7-view geometry."""
    tmp, jt, _ = reference
    jt.edit_change_mask = jnp.ones((1, RES, RES))
    try:
        ref_setup = jt.prepare_sds(skip_bootstrap=True)
    finally:
        jt.edit_change_mask = None
    assert ref_setup["edit_mask_pts"] is None

    cfg = torch_config_from_dict(_cfg_dict(tmp))
    mm = _port_mesh_model(tmp)
    mm.edit_change_mask = torch.ones((1, RES, RES))
    mlp = _port_mlp(jt.texture_params)
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    setup = tr.prepare_sds(cfg, mm, mlp, teacher, skip_bootstrap=True)
    assert setup["edit_mask_pts"] is None and setup["uv_grid_pts"] is None
    assert setup["mask_grid"] is None
    views, _ = tr.define_view_weights(mm, cfg.render)
    for got, full in zip(setup["cache6"], views):
        assert torch.equal(got, full[1:])
    cfg.optim.exact_lattice_render = False
    default = tr.prepare_sds(cfg, mm, mlp, teacher, skip_bootstrap=True)
    assert torch.equal(default["depth_grid"], setup["depth_grid"])
    assert default["cache6"] is None
    assert default["edit_mask_pts"].shape == (default["uv_grid_pts"].shape[0],
                                              1)
