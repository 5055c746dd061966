"""The guide's texture knobs in the port (contexture_nerf_tpu_torch
.training.trainer `load_texture_image`, `seed_texture_field`,
`map_coordinates_linear`, the masked step; models.textured_mesh
`fit_texture_to_image`) against the JAX reference, tiny models, f32, on the
CPU:

- guide.initial_texture: the MLP fitted to an image on the reference's own
  UV draws;
- guide.reference_texture: the image read as the reference reads it, the
  change mask, its samples at the grid's UVs (edit_mask_pts, against
  jax.scipy.ndimage.map_coordinates), and one masked SDS step's loss and
  MLP gradients on both render paths (the full canvas and local_sds_grad's
  slice);
- a run without the knobs draws the same random stream as before them.

The reference's gradients are read from its step with optax's Adam
replaced by a transformation that hands the gradients through.
"""

import logging
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.models.fields import fourier_embed
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import GuideConfig
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion.sd_depth import StableDiffusionDepth
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
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


def _cfg_dict(tmp, local=True, **guide):
    return {
        "log": {"exp_name": "torch_seed", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": dict({"text": "torch_seed", "shape_path": str(tmp / "s.obj"),
                       "texture_resolution": RES}, **guide),
        "optim": {"seed": 0, "sds_iterations": 1, "local_sds_grad": local,
                  "local_sds_margin_px": 8,
                  "precompute_uv_embedding": False},
    }


def _save_png(path, chw):
    Image.fromarray((np.clip(chw, 0, 1).transpose(1, 2, 0) * 255
                     ).round().astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A tiny reference trainer whose guide.reference_texture is its own
    initial texture map with the top half repainted at random: the change
    mask is then about half ones."""
    tmp = tmp_path_factory.mktemp("torch_seed")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    jt = jax_trainer.ConTEXTure(config_from_dict(_cfg_dict(tmp)),
                                tiny_models=True, backend="xla")
    tex, _ = jt.mesh_model.get_texture_map(jt.texture_params)
    img = np.array(tex[0])
    img[:, :RES // 2] = np.random.default_rng(1).uniform(
        0, 1, img[:, :RES // 2].shape)
    _save_png(tmp / "ref.png", img)
    jt.cfg.guide.reference_texture = tmp / "ref.png"
    jt._seed_texture_field(jt.mesh_model)
    setup = jt.prepare_sds(skip_bootstrap=True)
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


# -- guide.initial_texture ----------------------------------------------------

def _fit_both(tmp, jt, img, steps, batch=256, lr=1e-3):
    """The reference's fit and the port's on the reference's draws from one
    key. Returns (the reference's fitted params, the port's MLP, its
    losses)."""
    key = jax.random.PRNGKey(5)
    fitted = jt.mesh_model.fit_texture_to_image(
        jt.texture_params, jnp.asarray(img), key, steps=steps, lr=lr,
        batch=batch)
    draws = np.stack([np.asarray(jax.random.uniform(k, (batch, 2)))
                      for k in jax.random.split(key, steps)])
    mlp = _port_mlp(jt.texture_params)
    losses = _port_mesh_model(tmp).fit_texture_to_image(
        mlp, torch.from_numpy(img), steps=steps, lr=lr, batch=batch,
        uv_draws=torch.from_numpy(draws))
    return fitted, mlp, losses


def test_fit_texture_to_image_matches_reference(reference):
    """The fit on the reference's jax.random draws, f32, 256 points a step.
    One step moves a parameter by lr g / (|g| + 1e-8), the sign of its
    gradient unless the gradient is near eps: every parameter within 2 lr
    of the reference's, 99.9% of each leaf within 1e-5. Over four steps,
    Adam's ratios of gradients amplify the frameworks' float differences
    (the MLPs' outputs differ by ~1e-6 relative), so the fitted function
    is held instead: its
    colours at 1024 probe UVs within 5e-3 of the reference's, while the fit
    moved them by 0.1 or more on average."""
    tmp, jt, _ = reference
    img = np.random.default_rng(2).uniform(0, 1, (3, RES, RES)).astype(
        np.float32)
    fitted, mlp, losses = _fit_both(tmp, jt, img, 1)
    want = weights.convert_tree(jax.tree.map(np.asarray, fitted))
    assert set(mlp.state_dict()) == set(want)
    for k, v in mlp.state_dict().items():
        diff = (v - want[k]).abs()
        assert float(diff.max()) <= 2e-3, k
        assert float((diff <= 1e-5).float().mean()) >= 0.999, k

    fitted, mlp, losses = _fit_both(tmp, jt, img, 4)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())
    probe = np.random.default_rng(9).uniform(0, 1, (1024, 2)).astype(
        np.float32)

    def colours(params):
        out = jt.mesh_model.texture_mlp.apply(
            params, fourier_embed(jnp.asarray(probe), 10))
        return (np.tanh(np.asarray(out)) + 1) / 2

    got = _port_mesh_model(tmp).query_texture_at_uv(
        mlp, torch.from_numpy(probe)).detach().numpy()
    np.testing.assert_allclose(got, colours(fitted), atol=5e-3)
    assert np.abs(colours(fitted) - colours(jt.texture_params)).mean() > 0.1


def test_initial_texture_fit_draws_from_the_run_generator(tmp_path,
                                                          monkeypatch):
    """build_models draws the fit's UVs right after the MLP's init: the
    stream then runs on by exactly the fit's draws, and the MLP moved. A
    run without the knobs draws what it drew before them: the teacher, the
    MLP and the SD2-depth stack, in that order."""
    write_obj(tmp_path / "s.obj", *uv_sphere(6, 8))
    img = np.random.default_rng(3).uniform(0, 1, (3, RES, RES))
    _save_png(tmp_path / "init.png", img)
    monkeypatch.setattr(tr, "FIT_STEPS", 2)

    def replay(fit_steps):
        g = torch.Generator().manual_seed(0)
        Zero123PlusTeacher(tiny=True, device="cpu", generator=g)
        mlp = NeRF2D(generator=g, device="cpu")
        for _ in range(fit_steps):
            torch.rand((4096, 2), generator=g)
        StableDiffusionDepth(tiny=True, device="cpu", generator=g)
        return g.get_state(), mlp

    plain = torch_config_from_dict(_cfg_dict(tmp_path))
    gen, _, mlp, _, mm = tr.build_models(plain, tiny=True, device="cpu")
    state, mlp0 = replay(0)
    assert torch.equal(gen.get_state(), state)
    assert all(torch.equal(a, b) for a, b in zip(mlp.state_dict().values(),
                                                 mlp0.state_dict().values()))
    assert mm.edit_change_mask is None

    seeded = torch_config_from_dict(
        _cfg_dict(tmp_path, initial_texture=str(tmp_path / "init.png")))
    gen, _, mlp, _, _ = tr.build_models(seeded, tiny=True, device="cpu")
    state, _ = replay(2)
    assert torch.equal(gen.get_state(), state)
    assert any(not torch.equal(a, b) for a, b in zip(
        mlp.state_dict().values(), mlp0.state_dict().values()))


# -- reading the images -------------------------------------------------------

def test_load_texture_image_matches_reference(reference, tmp_path, caplog,
                                              monkeypatch):
    tmp, jt, _ = reference
    img = np.random.default_rng(4).uniform(0, 1, (3, 24, 40))
    _save_png(tmp_path / "odd.png", img)
    ref = jax_trainer.ConTEXTure._load_texture_image(jt, tmp_path / "odd.png")
    got = tr.load_texture_image(tmp_path / "odd.png", RES)
    assert got.shape == (3, RES, RES) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with caplog.at_level(logging.WARNING, logger="contexture_nerf_tpu_torch"):
        assert tr.load_texture_image(tmp_path / "missing.png", RES) is None
    assert "missing.png not found" in caplog.text
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow not installed
    with pytest.raises(ImportError):
        tr.load_texture_image(tmp_path / "odd.png", RES)


# -- guide.reference_texture --------------------------------------------------

def test_change_mask_matches_reference(reference, tmp_path):
    tmp, jt, _ = reference
    cfg = torch_config_from_dict(_cfg_dict(
        tmp, reference_texture=str(tmp / "ref.png")))
    mm = _port_mesh_model(tmp)
    tr.seed_texture_field(cfg, mm, _port_mlp(jt.texture_params), None)
    want = np.asarray(jt.edit_change_mask)
    assert 0.2 < want.mean() < 0.8  # edited and unedited texels both
    np.testing.assert_array_equal(mm.edit_change_mask.numpy(), want)
    # the run logs it as the reference does, with log.log_images
    d = _cfg_dict(tmp_path, reference_texture=str(tmp / "ref.png"))
    write_obj(tmp_path / "s.obj", *uv_sphere(6, 8))
    d["log"]["log_images"] = True
    run = tr.ConTEXTure(torch_config_from_dict(d), tiny_models=True,
                        device="cpu")
    run._img_writer.flush()
    assert (run.train_renders_path
            / "debug_reference_texture_change_mask.png").exists()
    assert run.mesh_model.edit_change_mask is not None


def test_map_coordinates_linear_matches_jax():
    """Bilinear, 0 outside (mode "constant"), at points inside, on the
    edges and outside the image."""
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 1, (RES, RES)) > 0.5).astype(np.float32)
    pts = rng.uniform(-1.5, RES + 0.5, (2, 4000)).astype(np.float32)
    pts[:, :64] = np.float32(RES - 1)  # the last row and column exactly
    want = jax.scipy.ndimage.map_coordinates(jnp.asarray(img),
                                             jnp.asarray(pts), order=1)
    got = tr.map_coordinates_linear(torch.from_numpy(img),
                                    torch.from_numpy(pts[0]),
                                    torch.from_numpy(pts[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_edit_mask_pts_match_reference(reference):
    """prepare_sds's samples of the change mask at the grid's UVs, on the
    reference's UVs and mask."""
    _, jt, setup = reference
    uv = torch.from_numpy(np.asarray(setup["uv_grid_pts"]))
    mask = torch.from_numpy(np.asarray(jt.edit_change_mask))
    got = tr.map_coordinates_linear(mask[0], uv[:, 1] * (RES - 1),
                                    uv[:, 0] * (RES - 1))[:, None]
    want = np.asarray(setup["edit_mask_pts"])
    assert want.shape == (uv.shape[0], 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert 0.0 < float(want.mean()) < 1.0


def test_prepare_sds_samples_the_change_mask(reference):
    """The port's prepare_sds gives edit_mask_pts from the mesh model's
    change mask at its own grid UVs."""
    tmp, jt, setup = reference
    cfg = torch_config_from_dict(_cfg_dict(tmp))
    mm = _port_mesh_model(tmp)
    mm.edit_change_mask = torch.from_numpy(np.asarray(jt.edit_change_mask))
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    out = tr.prepare_sds(cfg, mm, _port_mlp(jt.texture_params), teacher,
                         skip_bootstrap=True)
    res = mm.texture_resolution
    uv = out["uv_grid_pts"]
    want = tr.map_coordinates_linear(mm.edit_change_mask[0],
                                     uv[:, 1] * (res - 1),
                                     uv[:, 0] * (res - 1))[:, None]
    assert torch.equal(out["edit_mask_pts"], want)
    # the same grid UVs as the reference's, so the same samples
    np.testing.assert_allclose(out["edit_mask_pts"].numpy(),
                               np.asarray(setup["edit_mask_pts"]), atol=1e-3)


# -- the masked step ----------------------------------------------------------

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


def reference_step_grads(jt, setup, monkeypatch):
    """(loss, grid, MLP gradients as a torch state dict, hot) of one
    reference step: Adam replaced by a transformation whose update is the
    gradient and apply_updates by one that returns it."""
    passthrough = optax.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (g, s))
    monkeypatch.setattr(jax_trainer, "optax", SimpleNamespace(
        adam=lambda *a, **k: passthrough,
        apply_updates=lambda p, u: u, global_norm=optax.global_norm))
    step, optimizer, hot = jt._build_sds_step(setup, None)
    params = jt.texture_params
    grads, _, loss, _, _, grid = step(params, optimizer.init(params),
                                      jnp.asarray([T], jnp.int32),
                                      jax.random.PRNGKey(KEY), hot)
    monkeypatch.undo()
    return (float(loss), np.asarray(grid),
            weights.convert_tree(jax.tree.map(np.asarray, grads)), hot)


def port_step_grads(trainer, draws):
    _, loss, _, _, grid = trainer.step(T, draws)
    grads = {k: p.grad.clone() for k, p in trainer.mlp.named_parameters()}
    return float(loss), grid.numpy(), grads


def _port_trainer(tmp, jt, setup, local, **extra):
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher,
                         jax.tree.map(np.asarray, jt.zero123plus.params))
    keys = ("depth_grid", "mask_grid", "uv_grid_pts", "cond_lat_pair",
            "encoder_hidden_states", "tile_probs", "edit_mask_pts")
    setup_np = {k: np.asarray(setup[k]) for k in keys
                if setup.get(k) is not None}
    setup_np.update(extra)
    cfg = torch_config_from_dict(_cfg_dict(tmp, local=local))
    return tr.SDSTrainer(cfg, setup_np, teacher=teacher,
                         mlp=_port_mlp(jt.texture_params), tiny=True,
                         device="cpu")


def assert_grads_close(got, want):
    """f32 on both sides; XLA and torch sum the convolutions in other
    orders: each gradient within 2e-3 of its leaf's largest."""
    assert set(got) == set(want)
    for k, v in want.items():
        scale = float(v.abs().max())
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   atol=2e-3 * scale + 1e-9, err_msg=k)


@pytest.mark.parametrize("local", [False, True], ids=["canvas", "slice"])
def test_masked_step_matches_reference(reference, monkeypatch, local):
    tmp, jt, setup = reference
    jt.cfg.optim.local_sds_grad = local
    loss_r, grid_r, grads_r, hot = reference_step_grads(jt, setup,
                                                        monkeypatch)
    port = _port_trainer(tmp, jt, setup, local)
    assert port.edit_mask is not None
    draws = _draws(hot, port.latent_shape())
    loss, grid, grads = port_step_grads(port, draws)
    np.testing.assert_allclose(loss, loss_r, rtol=1e-4)
    np.testing.assert_allclose(grid, grid_r, atol=1e-5)
    assert_grads_close(grads, grads_r)
    # the mask localises the gradient: unmasked, the gradient differs
    unmasked = _port_trainer(tmp, jt, dict(setup, edit_mask_pts=None), local)
    _, _, free = port_step_grads(unmasked, draws)
    assert any(float((free[k] - grads[k]).abs().max())
               > 1e-2 * float(free[k].abs().max()) for k in free)
    # a mask of zeros leaves no gradient; the loss is the same
    zeros = np.zeros_like(np.asarray(setup["edit_mask_pts"]))
    frozen = _port_trainer(tmp, jt, setup, local, edit_mask_pts=zeros)
    loss0, _, none = port_step_grads(frozen, draws)
    assert all(float(g.abs().max()) == 0.0 for g in none.values())
    np.testing.assert_allclose(loss0, loss, rtol=1e-6)
