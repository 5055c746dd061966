"""The frozen reference against the port, at tiny size on the CPU, on one
set of weights made by portbench/weights.py: the towers (the UNet's write
and read passes with the reference attention, the ControlNet, the VAE
encoder and decoder), the texture field, the schedules, the geometry of
the six views, and whole SDS steps of the timed path on both the default
and the exact path. The reference itself imports nothing of the port; the
tests may."""

import math

import pytest
import torch

from portbench import harness
from portbench import weights as W
from portbench.reference import geometry as geo
from portbench.reference import sds as ref
from portbench.reference import towers as rt

SEED = 2 ** 31 + 77


def _port_and_reference(port_mod, ref_mod, name):
    leaves = W.spec(port_mod)
    assert leaves == W.spec(ref_mod)
    made = W.make_tower(leaves, SEED, name, torch.device("cpu"),
                        torch.float32)
    W.install(port_mod, made)
    W.install(ref_mod, {k: v.clone() for k, v in made.items()})


def _close(a, b, tol=2e-5):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm()) < tol


@pytest.fixture(scope="module")
def unets():
    from contexture_nerf_tpu_torch.diffusion.controlnet import ControlNet
    from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                          UNetConfig)

    pu, pc = UNet2DCondition(UNetConfig.tiny()), ControlNet(UNetConfig.tiny())
    ru, rc = rt.UNet2DCondition(rt.UNetConfig.tiny()), \
        rt.ControlNet(rt.UNetConfig.tiny())
    _port_and_reference(pu, ru, "unet")
    _port_and_reference(pc, rc, "controlnet")
    return pu, pc, ru, rc


def test_teacher_call_matches_the_port(unets):
    from contexture_nerf_tpu_torch.diffusion.controlnet import embed_cond

    pu, pc, ru, rc = unets
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(2, 4, 12, 8, generator=g)
    cond = torch.randn(2, 4, 4, 4, generator=g)
    ehs = torch.randn(2, 77, 32, generator=g)
    depth = torch.rand(1, 3, 96, 64, generator=g)
    t = torch.tensor([617])
    emb_p = embed_cond(pc, depth)
    emb_r = ref.hint_embedding(rc, depth, (12, 8))
    assert _close(emb_p, emb_r)
    refs_p, refs_r = [], []
    pu(cond, t, ehs, ref_out=refs_p)
    ru(cond, t, ehs, ref_out=refs_r)
    downs_p, mid_p = pc(lat, t, ehs, None, 2.0,
                        cond_embedding=torch.cat([emb_p] * 2))
    downs_r, mid_r = rc(lat, t, ehs, torch.cat([emb_r] * 2), 2.0)
    assert _close(mid_p, mid_r)
    v_p = pu(lat, t, ehs, down_residuals=downs_p, mid_residual=mid_p,
             ref_kv_list=refs_p)
    v_r = ru(lat, t, ehs, down_residuals=downs_r, mid_residual=mid_r,
             ref_kv_list=refs_r)
    assert _close(v_p, v_r)


def test_vae_matches_the_port():
    from contexture_nerf_tpu_torch.diffusion import vae

    pe, re_ = vae.Encoder(vae.VAEConfig.tiny()), rt.Encoder(rt.VAEConfig.tiny())
    pd, rd = vae.Decoder(vae.VAEConfig.tiny()), rt.Decoder(rt.VAEConfig.tiny())
    _port_and_reference(pe, re_, "vae_encoder")
    _port_and_reference(pd, rd, "vae_decoder")
    x = torch.rand(1, 3, 64, 48, generator=torch.Generator().manual_seed(2))
    mp, lp = vae.encode_moments(pe, x * 2 - 1)
    mr, lr = rt.encode_moments(re_, x * 2 - 1)
    assert _close(mp, mr) and _close(lp, lr)
    assert _close(vae.decode(pd, mp), rd(mr))


def test_texture_field_matches_the_port():
    from contexture_nerf_tpu_torch.models.fields import NeRF2D, fourier_embed
    from contexture_nerf_tpu_torch.ops.mlp_kernel import fused_nerf2d

    port = NeRF2D(device="cpu")
    mine = ref.NeRF2D()
    made = W.make_mlp(W.spec(port), SEED, torch.device("cpu"))
    W.install(port, made, requires_grad=True)
    W.install(mine, {k: v.clone() for k, v in made.items()},
              requires_grad=True)
    uv = torch.rand(500, 2, generator=torch.Generator().manual_seed(3))
    assert _close(port(fourier_embed(uv)), mine(uv))
    assert _close(fused_nerf2d(port, uv, 10), mine(uv))
    # the seeded init has the published spread: kaiming-normal weights
    w = made["pts_linear_1.weight"]
    assert abs(float(w.std()) - math.sqrt(2 / 256)) < 0.01


def test_schedules_match_the_port():
    from contexture_nerf_tpu_torch.diffusion import schedulers as sch

    a_p = sch.make_alphas_cumprod("cpu")
    a_r = ref.alphas_cumprod("cpu")
    assert torch.equal(a_p, a_r)
    assert sch.dreamtime_schedule(a_p, 5000).tolist() == \
        ref.dreamtime_schedule(a_r, 5000)


def test_geometry_matches_the_port_render():
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel

    cfg = config_from_dict({"guide": {
        "shape_path": str(harness.ROOT / "shapes" / "torus.obj")}})
    px = 96
    mm = TexturedMeshModel(cfg.guide, render_grid_size=px, device="cpu",
                           cache_path=None, write_cache=False)
    thetas = [math.radians(90 - e) for e in geo.ELEVATIONS]
    phis = [math.radians(a) for a in geo.AZIMUTHS]
    cache = mm.render_geometry(theta=thetas, phi=phis,
                               radius=[cfg.render.radius] * 6)
    g = geo.six_views(cfg.guide.shape_path, px, 32, cfg.guide.shape_scale,
                      cfg.guide.dy, cfg.render.radius, "cpu")
    mine = g["cache"]
    agree = float((cache.face_idx == mine[3]).float().mean())
    assert agree > 0.999
    both = (cache.face_idx == mine[3]) & (mine[3] >= 0)
    assert float((cache.uv_features - mine[1]).abs()[both].max()) < 1e-3
    assert float((cache.depth_map[:, 0] - mine[4][:, 0]).abs()[both].max()) \
        < 1e-3


def _tiny_run(cell_name, fault=None):
    cell = harness.Cell(cell_name)
    driver = cell.driver()
    state = driver.setup(cell, SEED, torch, device="cpu", tiny=True,
                         fault=fault)
    return driver.check(state, torch)


@pytest.mark.parametrize("cell", ["sds_default", "sds_exact"])
def test_sds_steps_match_the_reference(cell):
    """Three SDS steps through the program's timed call against the
    reference from the same weights, inputs and draws, all in f32."""
    check = _tiny_run(cell)
    assert check["fisher_gap"]["value"] < 1e-5
    assert check["grad_gap"]["value"] < 1e-4
    assert check["change_gap"]["value"] < 1e-3
