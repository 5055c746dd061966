"""SV3D_p as the SDS teacher (guide.teacher "sv3d_p"): the port's video UNet,
noise table and orbit step held to the benchmark's plain f32 reference
(portbench/reference/sv3d.py) at tiny size on the CPU, on one set of
weights made by portbench/weights.py; the temporal layers and the frame
order caught where they go wrong; the spans and host reads of a step; the
config key; a tiny paint through the CLI."""

import math

import pytest
import torch

from contexture_nerf_tpu_torch.core.config import (config_from_dict,
                                                   config_to_dict)
from contexture_nerf_tpu_torch.diffusion import sv3d
from contexture_nerf_tpu_torch.diffusion.video_unet import (VideoUNet,
                                                            VideoUNetConfig,
                                                            temporal_layers)
from portbench import common, harness
from portbench import weights as W
from portbench.reference import sds as ref_sds
from portbench.reference import sv3d as ref
from portbench.reference import towers as rt

SEED = 2 ** 31 + 21
# both sides compute in f32; they differ in the order of their sums only
# (the (3, 1, 1) convolution as a Conv2d over a view, the blenders as one
# lerp or addcmul), so the relative error is a few f32 ulps of the tower's
# depth: 1e-6 measured, held at 2e-5
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _tower(mod, name):
    """portbench's seeded weights, each blender's mix_factor near 0.5."""
    made = W.make_tower(W.spec(mod), SEED, name, torch.device("cpu"),
                        torch.float32)
    return {k: (0.5 + 0.25 * v if k.endswith("mix_factor") else v)
            for k, v in made.items()}


@pytest.fixture(scope="module")
def unets():
    port, plain = VideoUNet(VideoUNetConfig.tiny()), \
        ref.VideoUNet(ref.VideoUNetConfig.tiny())
    assert W.spec(port) == W.spec(plain)
    made = _tower(port, "unet")
    W.install(port, made)
    W.install(plain, {k: v.clone() for k, v in made.items()})
    g = torch.Generator().manual_seed(3)
    T = port.config.frames
    y = ref.vector_y(T, 10.0, 1e-5)
    inputs = (torch.randn(2 * T, 8, 16, 16, generator=g),
              torch.tensor([0.25 * math.log(7.3)]),
              torch.randn(2 * T, 1, 32, generator=g), torch.cat([y, y]))
    return port, plain, inputs


def test_video_unet_matches_the_reference(unets):
    port, plain, x = unets
    with torch.no_grad():
        assert _rel(port(*x), plain(*x)) < TOL


def test_spatial_only_and_a_frame_permutation_are_caught(unets):
    port, plain, (s, cn, ctx, y) = unets
    with torch.no_grad():
        want = plain(s, cn, ctx, y)
        T = port.config.frames
        perm = torch.tensor([1, 0, 2, 3, 4] * 2) + torch.tensor(
            [0] * T + [T] * T)
        got = port(s[perm], cn, ctx[perm], y[perm])[perm]
        assert _rel(got, want) > 100 * TOL
        saved = [m.mix_factor.clone() for m in port.mixers()]
        for m in port.mixers():
            m.mix_factor.fill_(1e4)
        try:
            assert _rel(port(s, cn, ctx, y), want) > 100 * TOL
        finally:
            for m, v in zip(port.mixers(), saved):
                m.mix_factor.copy_(v)
        assert _rel(port(s, cn, ctx, y), want) < TOL


def test_noise_table_in_closed_form():
    """sigma_i = (hi + (n-1-i)/(n-1) (lo - hi))^rho with lo, hi the
    rho-th roots of 0.002 and 700; alpha_bar = 1/(1+sigma^2); c_noise =
    ln(sigma)/4; and c_skip x_t + c_out v = x0 for the VP v-target."""
    s = sv3d.edm_sigmas()
    i = torch.arange(1000, dtype=torch.float64)
    lo, hi = 0.002 ** (1 / 7), 700.0 ** (1 / 7)
    closed = (hi + (999 - i) / 999 * (lo - hi)) ** 7
    assert torch.allclose(s.double(), closed, rtol=1e-6)
    assert math.isclose(float(s[0]), 0.002, rel_tol=1e-6)
    assert math.isclose(float(s[-1]), 700.0, rel_tol=1e-6)
    acp = sv3d.alphas_cumprod(s)
    assert torch.allclose(acp.double(), 1 / (1 + closed ** 2), rtol=1e-6)
    assert torch.allclose(sv3d.c_noise(s).double(), 0.25 * torch.log(closed),
                          rtol=1e-6, atol=1e-7)
    assert torch.allclose(acp, ref.alphas_cumprod(), rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(0)
    x0, n = torch.randn(2, 64, generator=g, dtype=torch.float64), \
        torch.randn(2, 64, generator=g, dtype=torch.float64)
    for k in (0, 500, 999):
        sig = closed[k]
        a = 1 / (1 + sig ** 2)
        v = a.sqrt() * n - (1 - a).sqrt() * x0
        x_t = x0 + sig * n
        assert torch.allclose(x_t / (sig ** 2 + 1).sqrt(),
                              a.sqrt() * x0 + (1 - a).sqrt() * n)
        denoised = x_t / (sig ** 2 + 1) - sig / (sig ** 2 + 1).sqrt() * v
        assert torch.allclose(denoised, x0)
    polar, az = sv3d.orbit_angles(21, 10.0)
    assert az[-1] == 0.0 and math.isclose(az[0], 2 * math.pi / 21)
    assert math.isclose(polar[0], math.radians(80.0))


def _trainer_and_reference():
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.training.orbit import OrbitSDSTrainer

    cfg = config_from_dict({"guide": {"teacher": "sv3d_p"},
                            "optim": {"data_parallel": "off"}})
    teacher = sv3d.SV3DTeacher(tiny=True, device="cpu")
    for t in ("unet", "vae_encoder"):
        W.install(getattr(teacher, t), _tower(getattr(teacher, t), t))
    mlp = NeRF2D(device="cpu")
    W.install(mlp, W.make_mlp(W.spec(mlp), SEED, torch.device("cpu")),
              requires_grad=True)
    p0 = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    g = ref.orbit_frames(harness.ROOT / "shapes" / "torus.obj", 64, 32, 5,
                         10.0, 0.6, 0.25, 1.5, "cpu")
    gen = torch.Generator().manual_seed(4)
    z_cond, ctx = torch.randn(1, 4, 16, 16, generator=gen), \
        torch.randn(1, 1, 32, generator=gen)
    setup = {"mask_frames": g["mask_frames"], "uv_frame_pts": g["uv_pts"],
             "z_cond": z_cond, "context": ctx,
             "frame_probs": torch.full((5,), 0.2)}
    trainer = OrbitSDSTrainer(cfg, setup, teacher=teacher, mlp=mlp,
                              tiny=True, device="cpu", mesh=None,
                              generator=torch.Generator().manual_seed(5))
    unet, vae = ref.VideoUNet(ref.VideoUNetConfig.tiny()), \
        rt.Encoder(rt.VAEConfig.tiny())
    W.install(unet, _tower(unet, "unet"))
    W.install(vae, _tower(vae, "vae_encoder"))
    rmlp = ref_sds.NeRF2D()
    W.install(rmlp, {k: v.clone() for k, v in p0.items()},
              requires_grad=True)
    o = cfg.optim
    r = ref.OrbitSDSReference(
        (unet, vae), rmlp, {"uv_pts": g["uv_pts"],
                            "mask_frames": g["mask_frames"],
                            "z_cond": z_cond, "context": ctx},
        32, rt.VAEConfig.tiny(), (5, 10.0, 1e-5, 2.5),
        (o.sds_lr, o.sds_betas, o.sds_eps))
    return trainer, r, p0


def test_a_trainer_step_matches_the_reference_step():
    trainer, r, p0 = _trainer_and_reference()
    t = ref.schedule(5000)[1000]
    d = trainer.draw()
    _, loss, _, fisher, _ = trainer.step(t, draws=d)
    st = trainer.optimizer.state
    out = r.step(t, d)
    for n, q in trainer.mlp.named_parameters():
        grad = st[q]["exp_avg"] / (1 - trainer.cfg.optim.sds_betas[0])
        assert _rel(grad, out["grads"][n]) < 1e-4, n
    # Adam's first step moves an element by about lr whatever its gradient,
    # so the change is held leaf by leaf in norm, over the leaves that a
    # gradient moves (the benchmark's comparison, portbench/common.py)
    change_p = {n: q.detach() - p0[n]
                for n, q in trainer.mlp.named_parameters()}
    change_r = {n: q.detach() - p0[n] for n, q in r.mlp.named_parameters()}
    gaps = common.leaf_gaps(change_p, change_r,
                            keep=common.moved_leaves(out["grads"]))
    assert max(gaps.values()) < 1e-4
    assert math.isclose(float(loss), out["loss"], rel_tol=1e-4)
    assert math.isclose(float(fisher), out["fisher"], rel_tol=1e-4)


def test_a_step_names_its_temporal_layers_and_reads_the_host_once():
    trainer, _, _ = _trainer_and_reference()
    t = ref.schedule(5000)[1000]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(t)
    ev = [(e.name, e.time_range.start) for e in prof.events()]
    teacher = [e for e in prof.events() if e.name == "sds.teacher"]
    assert len(teacher) == 1
    lo, hi = teacher[0].time_range.start, teacher[0].time_range.end
    temporal = [a for n, a in ev if n == "teacher.temporal"]
    assert len(temporal) == sum(temporal_layers(VideoUNetConfig.tiny()))
    assert all(lo <= a <= hi for a in temporal)
    assert [n for n, _ in ev if n.startswith("sync.")] == ["sync.tile_idx"]
    assert temporal_layers(VideoUNetConfig.sv3d_p()) == (22, 16)


def test_the_teacher_key_loads_dumps_and_checks():
    cfg = config_from_dict({"guide": {"teacher": "sv3d_p"}}, strict=True)
    assert cfg.guide.teacher == "sv3d_p"
    assert config_to_dict(cfg)["guide"]["teacher"] == "sv3d_p"
    assert "teacher" not in config_to_dict(config_from_dict({}))["guide"]
    with pytest.raises(ValueError, match="teacher"):
        config_from_dict({"guide": {"teacher": "zero123"}})


def test_the_cli_paints_with_sv3d(tmp_path, monkeypatch):
    """configs/sv3d/spot_sv3d_quick.yaml with tiny models, two iterations,
    a two-step bootstrap: the run's files, the teacher in its config."""
    import yaml

    from contexture_nerf_tpu_torch import run_contexture
    from contexture_nerf_tpu_torch.training import orbit
    from contexture_nerf_tpu_torch.training import trainer as tr

    monkeypatch.setattr(tr, "BOOTSTRAP_STEPS", 2)
    made = []
    orig = orbit.OrbitSDSTrainer.__init__

    def init(self, *a, **k):
        made.append(self)
        orig(self, *a, **k)

    monkeypatch.setattr(orbit.OrbitSDSTrainer, "__init__", init)
    argv = [f"--config_path={harness.ROOT / 'configs/sv3d/spot_sv3d_quick.yaml'}",
            f"--log.exp_root={tmp_path}", "--render.train_grid_size=48",
            "--render.eval_grid_size=32", "--guide.texture_resolution=16",
            "--log.full_eval_size=2", "--optim.sds_iterations=2",
            "--log.log_images=false"]
    run = run_contexture.main(argv, device="cpu", tiny_models=True)
    assert len(made) == 1 and run.sds is made[0]
    assert isinstance(run.teacher, sv3d.SV3DTeacher)
    exp = tmp_path / "spot_sv3d_quick"
    for name in ("metrics.json", "log.txt", "results/eval_texture_atlas.png",
                 "checkpoints/iter_000002"):
        assert (exp / name).exists(), name
    raw = yaml.safe_load((exp / "config.yaml").read_text())
    assert raw["guide"]["teacher"] == "sv3d_p"
