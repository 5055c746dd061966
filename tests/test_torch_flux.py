"""FLUX.1 Depth [dev] as the SDS teacher (guide.teacher "flux_depth"): the
port's MMDiT blocks, whole call, AE encode and three trainer steps held to
the benchmark's plain f32 reference (portbench/reference/flux.py) at tiny
size on the CPU, on one set of weights made by portbench/weights.py; the
rotary embedding against a hand-built rotation; the VP <-> flow identity;
packing; the spans and host reads of a step; the config key; a tiny paint
through the CLI."""

import math

import pytest
import torch

from contexture_nerf_tpu_torch.core.config import (config_from_dict,
                                                   config_to_dict)
from contexture_nerf_tpu_torch.diffusion import flux
from contexture_nerf_tpu_torch.diffusion.vae import Encoder, VAEConfig
from portbench import common, harness
from portbench import weights as W
from portbench.reference import flux as ref
from portbench.reference import geometry as geo
from portbench.reference import sds as ref_sds

SEED = 2 ** 31 + 25
# both sides compute in f32 with the same expressions for the modulation,
# RMSNorm and RoPE; the blocks and the whole call read 0 (bit for bit) with
# 2 threads, and another thread count orders the products' sums otherwise:
# held at 2e-5
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


def _weights(port, plain, name):
    assert W.spec(port) == W.spec(plain)
    made = W.make_tower(W.spec(port), SEED, name, torch.device("cpu"),
                        torch.float32)
    W.install(port, made)
    W.install(plain, {k: v.clone() for k, v in made.items()})


def _inputs(cfg, n_img=24, n_txt=8, hw=(4, 6)):
    g = torch.Generator().manual_seed(7)
    h = cfg.hidden_size
    img = torch.randn(1, n_img, h, generator=g)
    txt = torch.randn(1, n_txt, h, generator=g)
    vec = torch.randn(1, h, generator=g)
    img_ids, txt_ids = ref.ids_of(*hw, n_txt, "cpu")
    pe = ref.embed_nd(torch.cat([txt_ids, img_ids], 1), cfg.axes_dim,
                      cfg.theta)
    cos, sin = flux.rope_tables(torch.cat([txt_ids, img_ids], 1),
                                cfg.axes_dim, cfg.theta)
    return img, txt, vec, pe, cos, sin


def test_a_double_stream_block_matches_the_reference():
    cfg, rcfg = flux.FluxConfig.tiny(), ref.Config.tiny()
    port, plain = flux.DoubleStreamBlock(cfg), ref.DoubleStreamBlock(rcfg)
    _weights(port, plain, "double")
    img, txt, vec, pe, cos, sin = _inputs(cfg)
    with torch.no_grad():
        pi, pt = port(img, txt, vec, cos, sin)
        ri, rt_ = plain(img, txt, vec, pe)
    assert _rel(pi, ri) < TOL and _rel(pt, rt_) < TOL


def test_a_single_stream_block_matches_the_reference():
    cfg, rcfg = flux.FluxConfig.tiny(), ref.Config.tiny()
    port, plain = flux.SingleStreamBlock(cfg), ref.SingleStreamBlock(rcfg)
    _weights(port, plain, "single")
    img, txt, vec, pe, cos, sin = _inputs(cfg)
    x = torch.cat([txt, img], 1)
    with torch.no_grad():
        assert _rel(port(x, vec, cos, sin), plain(x, vec, pe)) < TOL


@pytest.fixture(scope="module")
def towers():
    cfg, rcfg = flux.FluxConfig.tiny(), ref.Config.tiny()
    port, plain = flux.FluxTransformer(cfg), ref.Flux(rcfg)
    _weights(port, plain, "transformer")
    return port, plain


def test_the_whole_call_matches_the_reference_and_rope_matters(towers):
    port, plain = towers
    cfg = port.config
    g = torch.Generator().manual_seed(8)
    hw, L = (6, 4), 8
    img = torch.randn(1, hw[0] * hw[1], cfg.in_channels, generator=g)
    txt = torch.randn(1, L, cfg.context_in_dim, generator=g)
    y = torch.randn(1, cfg.vec_in_dim, generator=g)
    t, guid = torch.tensor([0.63]), torch.tensor([10.0])
    img_ids, txt_ids = ref.ids_of(*hw, L, "cpu")
    with torch.no_grad():
        got = port(img, hw, txt, t, guid, y)
        want = plain(img, img_ids, txt, txt_ids, t, y, guid)
        assert _rel(got, want) < TOL
        # the rotary embedding carries weight: without it the call differs
        assert _rel(plain(img, img_ids, txt, txt_ids, t, y, guid,
                          use_rope=False), want) > 100 * TOL
        # and the guidance does
        assert _rel(port(img, hw, txt, t, torch.tensor([3.5]), y),
                    want) > 100 * TOL


def test_rope_against_a_hand_built_rotation():
    """Each axis a of width d_a turns pair i of its columns by
    pos_a theta^(-2i / d_a); the axes' columns follow one another."""
    axes, theta = (8, 12, 12), 10000
    ids = torch.tensor([[[0.0, 3.0, 5.0], [0.0, 0.0, 0.0], [0.0, 7.0, 1.0]]])
    cos, sin = flux.rope_tables(ids, axes, theta)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 3, 2, sum(axes), generator=g)
    got = flux.apply_rope(x, cos, sin)
    want = torch.empty_like(x)
    for l in range(3):
        col = 0
        for a, d in enumerate(axes):
            for i in range(d // 2):
                ang = float(ids[0, l, a]) * theta ** (-2.0 * i / d)
                c, s = math.cos(ang), math.sin(ang)
                x0, x1 = x[0, l, :, col], x[0, l, :, col + 1]
                want[0, l, :, col] = c * x0 - s * x1
                want[0, l, :, col + 1] = s * x0 + c * x1
                col += 2
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    # the text tokens (position 0) are not turned
    assert torch.equal(got[0, 1], x[0, 1])


def test_the_vp_flow_identity_on_exact_draws():
    """At each index of the table: s x is the flow latent (1 - t) x0 + t eps
    of the VP latent x, and the exact velocity eps - x0 converts to the VP
    v-target sqrt(a) eps - sqrt(1 - a) x0."""
    mu = flux.flow_mu(2400)
    table = flux.flow_table(mu)
    g = torch.Generator().manual_seed(10)
    x0 = torch.randn(2, 16, 6, 4, generator=g, dtype=torch.float64)
    eps = torch.randn(2, 16, 6, 4, generator=g, dtype=torch.float64)
    for i in (0, 250, 614, 999):
        # the identity in f64; the table holds these values rounded to f32
        t = flux.time_shift(mu, torch.tensor((i + 1) / 1000,
                                             dtype=torch.float64))
        s = ((1 - t) ** 2 + t ** 2).sqrt()
        a = (1 - t) ** 2 / s ** 2
        for k, v in (("t", t), ("s", s), ("alphas_cumprod", a)):
            assert float(table[k][i]) == float(v.float()), k
        x = a.sqrt() * x0 + (1 - a).sqrt() * eps
        assert torch.allclose(s * x, (1 - t) * x0 + t * eps, atol=1e-12)
        v = flux.flow_to_vp(x, eps - x0, t, s)
        assert torch.allclose(v, a.sqrt() * eps - (1 - a).sqrt() * x0,
                              atol=1e-12)
    assert math.isclose(flux.flow_mu(2400), 0.86291666, rel_tol=1e-6)
    assert torch.allclose(table["alphas_cumprod"],
                          ref.alphas_cumprod(2400), rtol=1e-6, atol=0)
    assert float(table["t"][-1]) == 1.0 and float(table["t"][0]) > 0


def test_pack_and_unpack_are_inverse():
    g = torch.Generator().manual_seed(11)
    z = torch.randn(2, 16, 12, 8, generator=g)
    p = flux.pack(z)
    assert p.shape == (2, 24, 64)
    assert torch.equal(flux.unpack(p, 6, 4), z)
    assert torch.equal(p, ref.pack(z))
    # a token holds one 2x2 patch of every channel, (c ph pw) order
    assert torch.equal(p[0, 5, :4], z[0, 0, 2:4, 2:4].reshape(-1))


def test_the_flux_ae_encode_matches_the_reference():
    port = Encoder(VAEConfig.flux(tiny=True))
    plain = ref.ae_encoder(ref.vae_config(True))
    _weights(port, plain, "vae_encoder")
    assert port.quant_conv is None
    g = torch.Generator().manual_seed(12)
    img = torch.rand(1, 3, 32, 48, generator=g) * 2 - 1
    teacher = flux.FluxDepthTeacher(tiny=True, device="cpu")
    teacher.vae_encoder = port
    eps = torch.randn(1, 16, 16, 24, generator=g)
    with torch.no_grad():
        r = ref.FluxSDSReference.__new__(ref.FluxSDSReference)
        r.vae = plain
        for e in (None, eps):
            assert _rel(teacher.latents(img, e), r._latents(img, e)) < TOL


def _trainer_and_reference():
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.training.trainer import FluxSDSTrainer

    cfg = config_from_dict({"guide": {"teacher": "flux_depth"},
                            "optim": {"data_parallel": "off"}})
    teacher = flux.FluxDepthTeacher(tiny=True, device="cpu")
    for t in ("transformer", "vae_encoder"):
        W.install(getattr(teacher, t), W.make_tower(
            W.spec(getattr(teacher, t)), SEED, t, torch.device("cpu"),
            torch.float32))
    mlp = NeRF2D(device="cpu")
    W.install(mlp, W.make_mlp(W.spec(mlp), SEED, torch.device("cpu")),
              requires_grad=True)
    p0 = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    g = geo.six_views(harness.ROOT / "shapes" / "torus.obj", 96, 32, 0.6,
                      0.25, 1.5, "cpu")
    gen = torch.Generator().manual_seed(4)
    txt, vec = teacher.prompt_states(gen)
    setup = {"depth_grid": g["depth_grid"], "mask_grid": g["mask_grid"],
             "uv_grid_pts": g["uv_pts"], "txt": txt, "vec": vec,
             "tile_probs": torch.full((6,), 1 / 6)}
    trainer = FluxSDSTrainer(cfg, setup, teacher=teacher, mlp=mlp,
                             tiny=True, device="cpu", mesh=None,
                             generator=torch.Generator().manual_seed(5))
    plain = ref.Flux(ref.Config.tiny())
    vae = ref.ae_encoder(ref.vae_config(True))
    for t, m in (("transformer", plain), ("vae_encoder", vae)):
        W.install(m, W.make_tower(W.spec(m), SEED, t, torch.device("cpu"),
                                  torch.float32))
    rmlp = ref_sds.NeRF2D()
    W.install(rmlp, {k: v.clone() for k, v in p0.items()},
              requires_grad=True)
    o = cfg.optim
    r = ref.FluxSDSReference(
        (plain, vae), rmlp, {"depth_grid": g["depth_grid"],
                             "mask_grid": g["mask_grid"],
                             "uv_pts": g["uv_pts"], "txt": txt, "vec": vec},
        32, o.local_sds_margin_px, (o.sds_lr, o.sds_betas, o.sds_eps))
    return trainer, r, p0


def test_three_trainer_steps_match_the_reference_steps():
    trainer, r, p0 = _trainer_and_reference()
    assert _rel(trainer.control, r.control) < TOL
    ts = ref.schedule(trainer.teacher.image_tokens, 5000)
    assert ts[1000] == trainer.t_schedule(5000).tolist()[1000]
    v_preds = []
    teach = trainer._teacher
    trainer._teacher = lambda *a: v_preds.append(teach(*a)) or v_preds[-1]
    for i in range(3):
        d = trainer.draw()
        _, loss, _, fisher, _ = trainer.step(ts[1000 + i], draws=d)
        if i == 0:
            st = trainer.optimizer.state
            grads = {n: st[q]["exp_avg"] / (1 - trainer.cfg.optim.sds_betas[0])
                     for n, q in trainer.mlp.named_parameters()}
        out = r.step(ts[1000 + i], d)
        assert _rel(v_preds[-1], out["v_pred"]) < TOL
        assert math.isclose(float(loss), out["loss"], rel_tol=1e-4)
        assert math.isclose(float(fisher), out["fisher"], rel_tol=1e-4)
        if i == 0:
            for n, gr in grads.items():
                assert _rel(gr, out["grads"][n]) < 1e-4, n
    change_p = {n: q.detach() - p0[n]
                for n, q in trainer.mlp.named_parameters()}
    change_r = {n: q.detach() - p0[n] for n, q in r.mlp.named_parameters()}
    gaps = common.leaf_gaps(change_p, change_r,
                            keep=common.moved_leaves(out["grads"]))
    assert max(gaps.values()) < 1e-3


def test_a_step_names_its_blocks_and_reads_the_host_once():
    trainer, _, _ = _trainer_and_reference()
    t = ref.schedule(trainer.teacher.image_tokens, 5000)[1000]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(t)
    ev = [(e.name, e.time_range.start) for e in prof.events()]
    teacher = [e for e in prof.events() if e.name == "sds.teacher"]
    assert len(teacher) == 1
    lo, hi = teacher[0].time_range.start, teacher[0].time_range.end
    cfg = trainer.teacher.config
    for name, n in (("flux.double", cfg.depth),
                    ("flux.single", cfg.depth_single_blocks)):
        starts = [a for m, a in ev if m == name]
        assert len(starts) == n and all(lo <= a <= hi for a in starts)
    assert [n for n, _ in ev if n.startswith("sync.")] == ["sync.tile_idx"]
    assert trainer.teacher.counts == {"calls": 1, "image_tokens": 384,
                                      "text_tokens": 8}


def test_the_teacher_key_loads_dumps_and_refuses_what_it_lacks():
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = config_from_dict({"guide": {"teacher": "flux_depth"}}, strict=True)
    assert config_to_dict(cfg)["guide"]["teacher"] == "flux_depth"
    path = tr.teacher_path(cfg)
    assert path.trainer is tr.FluxSDSTrainer
    assert path.prepare is tr.prepare_flux_sds
    assert path.teacher is flux.FluxDepthTeacher
    for over in ({"optim": {"exact_lattice_render": True}},
                 {"guide": {"individual_control_of_conditions": True,
                            "guidance_scale_i": 1.0,
                            "guidance_scale_t": 1.0}}):
        bad = config_from_dict({"guide": {"teacher": "flux_depth",
                                          **over.get("guide", {})},
                                "optim": over.get("optim", {})})
        with pytest.raises(ValueError):
            tr.FluxSDSTrainer(bad, {}, tiny=True, device="cpu", mesh=None)


def test_the_cli_paints_with_flux(tmp_path, monkeypatch):
    """configs/flux/spot_flux_quick.yaml with tiny models, two iterations:
    the run's files, the teacher in its config, no SD2 stack built."""
    import yaml

    from contexture_nerf_tpu_torch import run_contexture
    from contexture_nerf_tpu_torch.training import trainer as tr

    made = []
    orig = tr.FluxSDSTrainer.__init__

    def init(self, *a, **k):
        made.append(self)
        orig(self, *a, **k)

    monkeypatch.setattr(tr.FluxSDSTrainer, "__init__", init)
    argv = [f"--config_path={harness.ROOT / 'configs/flux/spot_flux_quick.yaml'}",
            f"--log.exp_root={tmp_path}", "--render.train_grid_size=48",
            "--render.eval_grid_size=32", "--guide.texture_resolution=16",
            "--log.full_eval_size=2", "--optim.sds_iterations=2",
            "--log.log_images=false"]
    run = run_contexture.main(argv, device="cpu", tiny_models=True)
    assert len(made) == 1 and run.sds is made[0]
    assert isinstance(run.teacher, flux.FluxDepthTeacher)
    assert run.diffusion is None and run.teacher.counts["calls"] == 2
    exp = tmp_path / "spot_flux_quick"
    for name in ("metrics.json", "log.txt", "results/eval_texture_atlas.png",
                 "checkpoints/iter_000002"):
        assert (exp / name).exists(), name
    raw = yaml.safe_load((exp / "config.yaml").read_text())
    assert raw["guide"]["teacher"] == "flux_depth"


def test_the_census_counts_each_block_attention_by_head_dim(monkeypatch):
    """Every block's joint attention goes through `layers.attention`, so
    the launch census sees it: with the routing thresholds lowered to the
    tiny call's lengths, a teacher call routes 2 + 2 calls to K3, all at
    the tiny head dim (128 at full size)."""
    from contexture_nerf_tpu_torch.ops import attention as att
    from contexture_nerf_tpu_torch.tools.launches import census

    monkeypatch.setattr(att, "MIN_SQ_KERNEL", 16)
    monkeypatch.setattr(att, "MIN_KV_KERNEL", 16)
    teacher = flux.FluxDepthTeacher(tiny=True, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    txt, vec = teacher.prompt_states(g)
    control = teacher.control_latents(torch.rand(1, 3, 96, 64, generator=g))
    with census() as c:
        teacher.teacher_v_pred(torch.randn(1, 16, 48, 32, generator=g),
                               torch.tensor([500]), control, txt, vec)
    cfg = teacher.config
    n = cfg.depth + cfg.depth_single_blocks
    assert c.counts["flash_attn_single"] == n
    assert c.head_dims == {("flash_attn_single", cfg.head_dim): n}
