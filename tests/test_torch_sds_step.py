"""The port's SDS step (contexture_nerf_tpu_torch.training.trainer) against
one step of the JAX reference (`ConTEXTure._build_sds_step`), tiny models,
f32, on the CPU.

One tiny JAX trainer is built per module; its `prepare_sds` output, its
weights (through the port's bridge) and the step's random draws (re-derived
here with jax.random from the same key) feed the port's `step(draws=...)`.
The reference's precomputed-embedding path runs its Pallas kernel in
interpret mode, as tests/test_local_grad.py does.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.training.trainer import ConTEXTure
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.diffusion.schedulers import \
    make_alphas_cumprod
from contexture_nerf_tpu_torch.models.fields import NeRF2D, uv_lattice
from contexture_nerf_tpu_torch.training.trainer import (
    SDSTrainer, build_sds_trainer)
from tools.make_shapes import uv_sphere, write_obj

T = 500
KEY = 3
MARGIN = 8  # px; the tiny VAE downsamples 2x, so the slice is 48x48


def _cfg_dict(tmp, local, precompute):
    return {
        "log": {"exp_name": "torch_sds", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "torch_sds", "shape_path": str(tmp / "s.obj"),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": 1,
                  "local_sds_grad": local, "local_sds_margin_px": MARGIN,
                  "precompute_uv_embedding": precompute},
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sds")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_trainer, "_FUSED_EMB_INTERPRET", True)
    try:
        tr = ConTEXTure(config_from_dict(_cfg_dict(tmp, True, True)),
                        tiny_models=True, backend="xla")
        setup = tr.prepare_sds(skip_bootstrap=True)
        assert setup["emb_pts"] is not None
        yield tmp, tr, setup
    finally:
        mp.undo()


def _reference_step(tr, setup, local, precompute):
    tr.cfg.optim.local_sds_grad = local
    setup = dict(setup) if precompute else dict(setup, emb_pts=None)
    step, optimizer, hot = tr._build_sds_step(setup, None)
    params = tr.texture_params
    out = step(params, optimizer.init(params), jnp.asarray([T], jnp.int32),
               jax.random.PRNGKey(KEY), hot)
    return out, hot


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


def _port_trainer(tmp, tr, setup, local, precompute):
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher,
                         jax.tree.map(np.asarray, tr.zero123plus.params))
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    keys = ("depth_grid", "mask_grid", "uv_grid_pts", "cond_lat_pair",
            "encoder_hidden_states", "tile_probs")
    setup_np = {k: np.asarray(setup[k]) for k in keys}
    cfg = torch_config_from_dict(_cfg_dict(tmp, local, precompute))
    return SDSTrainer(cfg, setup_np, teacher=teacher, mlp=mlp, tiny=True,
                      device="cpu")


@pytest.mark.parametrize("local,precompute", [
    (True, True), (True, False), (False, True), (False, False)])
def test_sds_step_matches_reference(reference, local, precompute):
    tmp, tr, setup = reference
    (p_ref, _, loss_ref, gn_ref, fisher_ref, grid_ref), hot = \
        _reference_step(tr, setup, local, precompute)
    port = _port_trainer(tmp, tr, setup, local, precompute)
    draws = _draws(hot, port.latent_shape())
    params, loss, gn, fisher, grid = port.step(T, draws)

    # f32 throughout; XLA and torch sum convolutions in other orders
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(gn_ref), rtol=1e-3)
    np.testing.assert_allclose(float(fisher), float(fisher_ref), rtol=1e-3)
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_ref),
                               atol=1e-5)
    # Adam's first step moves each element by about +-lr whatever the
    # gradient's size, so 3 lr bounds only the elementwise drift; the
    # direction is held separately: the update's sign must agree with the
    # reference's on at least 99% of each leaf (a flipped SDS gradient or
    # swapped leaves disagree almost everywhere; near-zero gradients may
    # flip under reassociation)
    lr = tr.cfg.optim.sds_lr
    ref_sd = weights.convert_tree(jax.tree.map(np.asarray, p_ref))
    old = weights.convert_tree(jax.tree.map(np.asarray, tr.texture_params))
    assert set(ref_sd) == set(params)
    for k, v in ref_sd.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(),
                                   atol=3 * lr, err_msg=k)
        step_ref = torch.sign(v - old[k])
        agree = float((torch.sign(params[k] - old[k]) == step_ref)
                      .float().mean())
        assert agree >= 0.99, (k, agree)
        assert bool((step_ref != 0).any()), k


def test_paint_loop_follows_the_dreamtime_schedule(reference):
    tmp, tr, setup = reference
    port = _port_trainer(tmp, tr, setup, True, True)
    before = {k: v.clone() for k, v in port.mlp.state_dict().items()}
    metrics = port.paint(2)
    ts = port.t_schedule(2).tolist()
    assert [m["iter"] for m in metrics] == [0, 1]
    assert [m["t"] for m in metrics] == ts and ts[0] > ts[1]
    assert all(np.isfinite(m["sds_loss"]) for m in metrics)
    assert any(not torch.equal(before[k], v)
               for k, v in port.mlp.state_dict().items())


def test_exact_lattice_render_waits_for_rasterizer(tmp_path, caplog):
    """The exact branch is built from prepare_sds's cache6 and the mesh
    model, and turns local_sds_grad off with the reference's warning;
    without them it raises."""
    write_obj(tmp_path / "s.obj", *uv_sphere(6, 8))
    d = _cfg_dict(tmp_path, True, True)
    d["optim"]["exact_lattice_render"] = True
    cfg = torch_config_from_dict(d)
    with pytest.raises(ValueError, match="rasterizer"):
        SDSTrainer(cfg, {}, tiny=True, device="cpu")
    with caplog.at_level(logging.WARNING, logger="contexture_nerf_tpu_torch"):
        trainer, setup = build_sds_trainer(cfg, tiny=True, device="cpu",
                                           skip_bootstrap=True)
    assert "disabling optim.local_sds_grad" in caplog.text
    assert trainer.exact and not trainer.local_grad
    assert len(setup["cache6"].face_idx) == 6
    assert setup["uv_grid_pts"] is None and setup["mask_grid"] is None


def test_entry_points_default_to_the_card():
    """Without a GPU, the default device raises instead of running on the
    CPU; the CPU runs only on request."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Zero123PlusTeacher(tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeRF2D()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        uv_lattice(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_alphas_cumprod()
    cfg = torch_config_from_dict({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SDSTrainer(cfg, {}, tiny=True)
