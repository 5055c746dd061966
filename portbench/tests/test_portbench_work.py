"""The benchmark's work counts: the SDS step's FLOPs against
torch.utils.flop_counter over the frozen reference at tiny size, and the
per-kernel counts against chip_smoke.py's formulas at the main path's
shapes (K1 481,024 multiply-adds a point, K2's backward, K3/K4's FLOPs,
K6's 4.27 GB a step)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from portbench import harness
from portbench import weights as W
from portbench.reference import geometry as geo
from portbench.reference import sds as ref
from portbench.reference import towers as rt
from portbench.work import counts

SEED = 2 ** 31 + 5


def _reference(exact: bool, local: bool, margin: int, tex: int):
    u, v = rt.UNetConfig.tiny(), rt.VAEConfig.tiny()
    towers = (rt.UNet2DCondition(u), rt.ControlNet(u), rt.Encoder(v))
    for name, m in zip(("unet", "controlnet", "vae_encoder"), towers):
        W.install(m, W.make_tower(W.spec(m), SEED, name, torch.device("cpu"),
                                  torch.float32))
    mlp = ref.NeRF2D()
    W.install(mlp, W.make_mlp(W.spec(mlp), SEED, torch.device("cpu")),
              requires_grad=True)
    g = geo.six_views(harness.ROOT / "shapes" / "torus.obj", 96, 32, 0.6,
                      0.25, 1.5, "cpu")
    gen = torch.Generator().manual_seed(9)
    inputs = {"depth_grid": g["depth_grid"], "mask_grid": g["mask_grid"],
              "uv_pts": g["uv_pts"],
              "cond_lat_pair": torch.randn(2, 4, 16, 16, generator=gen),
              "ehs": torch.randn(2, 77, 32, generator=gen),
              "cache_uv": g["cache"][1], "cache_mask": g["cache"][8],
              "bboxes6": g["bboxes6"]}
    r = ref.SDSReference(towers, mlp, inputs, 32, v, exact, local, margin,
                         tex, (1e-5, (0.9, 0.99), 1e-15))
    d = {"tile_idx": torch.tensor([4]),
         "eps": torch.randn(1, 4, 48, 32, generator=gen),
         "noise": torch.randn(1, 4, 48, 32, generator=gen),
         "neg_noise": torch.randn(4, 16, 16, generator=gen),
         "cond_noise": torch.randn(4, 16, 16, generator=gen)}
    return r, d, u, v


@pytest.mark.parametrize("exact,local", [(False, True), (False, False),
                                         (True, False)])
def test_step_flops_match_the_flop_counter(exact, local):
    r, d, u, v = _reference(exact, local, margin=8, tex=64)
    with FlopCounterMode(display=False) as fc:
        r.step(300, d)
    want = counts.sds_step(u, v, 32, 32, exact, local, 8, 64)["flops"]
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_mlp_counts_match_chip_smoke():
    from contexture_nerf_tpu_torch.models.fields import NeRF2D

    mlp = NeRF2D(device="meta")
    macs = sum(lin.in_features * lin.out_features for lin in mlp.linears())
    assert counts.mlp_macs() == macs == 481_024
    n = 200_704
    assert counts.mlp_fwd_flops(n) == 2.0 * n * macs
    # chip_smoke.py's K2 count recomputes the forward; the benchmark's does
    # not
    k2 = 2.0 * n * (3 * macs - 42 * 256)
    assert counts.mlp_bwd_flops(n) + counts.mlp_fwd_flops(n) == k2


def test_attention_flops_match_chip_smoke():
    for B, H, sq, skv in [(2, 5, 9600, 9600 + 1600), (2, 20, 600, 77)]:
        assert counts.attention_flops(B, H, sq, skv, 64) == \
            4.0 * B * H * sq * skv * 64


def test_groupnorm_bytes_of_a_default_step():
    """Every GroupNorm call of one default step at the main path's shapes
    (the towers on the meta device): 193 calls, 4.27 GB in bf16."""
    u, v = rt.UNetConfig(), rt.VAEConfig()
    with torch.device("meta"):
        unet, cn, enc = rt.UNet2DCondition(u), rt.ControlNet(u), rt.Encoder(v)
    seen = []

    def hook(mod, inputs):
        x = inputs[0].to(torch.bfloat16)
        seen.append(chip_smoke.groupnorm_bytes(torch, x, torch.bfloat16))

    for tower in (unet, cn, enc):
        for m in tower.modules():
            if isinstance(m, rt.GroupNormSiLU):
                m.register_forward_pre_hook(hook)
    meta = dict(device="meta")
    with torch.no_grad():
        enc(torch.zeros(1, 3, 960, 640, **meta))
        enc(torch.zeros(1, 3, 448, 448, **meta))
        refs = []
        ehs = torch.zeros(2, 77, 1024, **meta)
        unet(torch.zeros(2, 4, 40, 40, **meta), 500, ehs, ref_out=refs)
        lat = torch.zeros(2, 4, 120, 80, **meta)
        downs, mid = cn(lat, 500, ehs, torch.zeros(2, 320, 120, 80, **meta))
        unet(lat, 500, ehs, down_residuals=downs, mid_residual=mid,
             ref_kv_list=refs)
    assert len(seen) == 193
    total = sum(seen)
    assert abs(total / 1e9 - 4.27) < 0.005
    assert total == sum(counts.groupnorm_bytes(b // 4, 2, 2) for b in seen)


def test_grid_flops_match_the_flop_counter():
    from portbench.reference import generate as rg

    u, v = rt.UNetConfig.tiny(), rt.VAEConfig.tiny()
    tc, vc = rg.CLIPTextConfig.tiny(), rg.CLIPVisionConfig.tiny()
    vc.projection_dim = tc.hidden_size
    mods = {"unet": rt.UNet2DCondition(u), "controlnet": rt.ControlNet(u),
            "vae_encoder": rt.Encoder(v), "text_encoder": rg.CLIPTextModel(tc),
            "vision_encoder": rg.CLIPVisionModelWithProjection(vc),
            "vae_decoder": rt.Decoder(v)}
    for name, m in mods.items():
        W.install(m, W.make_tower(W.spec(m), SEED, name, torch.device("cpu"),
                                  torch.float32))
    gen = torch.Generator().manual_seed(4)
    n = 3
    draws = {"eps_cond": torch.randn(1, 4, 16, 16, generator=gen),
             "eps_neg": torch.randn(1, 4, 16, 16, generator=gen),
             "latents": torch.randn(1, 4, 48, 32, generator=gen),
             "write_neg": torch.randn(n, 4, 16, 16, generator=gen),
             "write_cond": torch.randn(n, 4, 16, 16, generator=gen),
             "step": torch.randn(n, 1, 4, 48, 32, generator=gen)}
    cond = torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1
    depth = torch.rand(1, 3, 96, 64, generator=gen)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rg.generate(mods, ref.alphas_cumprod("cpu"), cond, depth, draws,
                    torch.linspace(0, 1, 77), n, 4.0, v)
    want = counts.grid(u, v, tc, vc, 96, 64, 32, n)["flops"]
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)
