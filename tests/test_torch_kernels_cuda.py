"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports neither JAX nor the JAX package, so it also runs on a machine
without them; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Point counts and sequence lengths are ragged (not multiples of the kernels'
64-row blocks) to exercise the masked tails. Tolerances: the MLP kernels and
their plain versions round every matmul operand to bf16 at the same points
and sum in f32 in other orders; a one-ulp flip cascades through the later
layers. The plain bf16 version's distance from plain f32 measures that
noise, and a kernel must stay within twice it (or 1e-3 of max|plain| where
bf16 is exact), as chip_smoke.py holds them. Attention: the kernel rounds
P to bf16 before normalising it, the plain version after, and both round
the output; the kernel must stay within chip_smoke.attention_limit (the
bound those roundings give, per element, plus one bf16 ulp), run
bit-identically twice, and a softmax scale of 1/sqrt(128), a dropped
second KV source and unmasked ragged tails must miss the limit. The
rasterizer (K5) repeats its plain
version's arithmetic without FMA contraction and breaks z ties by the lowest
face index: face_idx must agree on at least 99.99% of covered pixels, every
mismatch a z tie (|dz| <= 1e-6) or an edge pixel (min barycentric <= 1e-5),
bary within 1e-5 where the faces agree, and two runs bit-identical; a
reversed z test, a dropped last face chunk and tile ranges one column short
must miss those limits. Its setup kernel's records and pixel ranges must
equal their plain versions (`face_records`, `pixel_ranges`) exactly. At
the eval path's shapes (a 1024^2 turntable frame, the metric's 6 x 192^2
views, the UV-space raster with every z equal) K5 must be bit-identical to
its plain version.
GroupNorm (K6), one launch a call, repeats its plain version's elementwise
arithmetic and sums the f32 statistics in another order: bf16 output within one bf16 ulp of the
plain output plus a floor from the statistics' rounding, f32 output within
4x the plain f32 path's distance from f64 (chip_smoke.groupnorm_limit), two
runs bit-identical; a group boundary shifted by one channel, a dropped SiLU
and one CTA's share left out of the sums must miss those limits. Its
backward (gn_bwd) at the VAE encoder's GroupNorms of the SDS step (the
448x448 slice and the 960x640 canvas) and at ragged or misaligned inputs:
each output within one ulp of its dtype at the closed form's magnitude plus
what its f32 sums' rounding can move it (chip_smoke.groupnorm_bwd_limit),
two runs bit-identical, and SiLU's slope cut to sigmoid(y), the projection
term dropped and one CTA's share left out of the group's sums must miss the
limit; under autograd, K6's gradients are gn_bwd's, within the same limit.
The masked texture sample (K7) at the exact path's 6 x 1200^2 views and
1024^2 texture (bilinear and nearest) and at a ragged shape: its forward
bit-identical to the plain version (both round every operation on its own
in one order), its backward bit-identical to the plain segment sum on the
CPU (the plan's order), within chip_smoke.k7_limit of autograd through the
plain gathers (the same terms in other orders), two runs bit-identical, and
a view left out of the sums and each texel's list read from the next
texel's must miss the limit; one exact_lattice_render step launches K7's
forward and backward once each, as the trainer derives.
"""

import pytest
import torch

from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.models.fields import NeRF2D, uv_lattice
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import attention as att
from contexture_nerf_tpu_torch.ops import groupnorm as gn
from contexture_nerf_tpu_torch.ops import mlp_kernel as mk
from contexture_nerf_tpu_torch.ops import texture as tx
from contexture_nerf_tpu_torch.raster import raster_kernel as rk
from contexture_nerf_tpu_torch.raster.rasterize import rasterize_geometry
from contexture_nerf_tpu_torch.training.trainer import view_angles
from chip_smoke import (ATTENTION_FAULTS, BWD_FAULTS, K7_FAULTS, activations,
                        attention_limit, attention_ratio, binned_plain,
                        groupnorm_bwd_limit, groupnorm_bwd_ratio,
                        groupnorm_limit, groupnorm_ratio, k7_limit,
                        numpy_uv_sphere, output_gradient, planted_attention,
                        planted_group_norm, planted_group_norm_bwd,
                        planted_k7_bwd, shrunk_ranges, texture_cases,
                        vae_encoder_groupnorms)
from tools.make_shapes import uv_sphere

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda")


def _agrees(got, plain, plain_f32):
    err = float((got - plain).abs().max())
    noise = float((plain - plain_f32).abs().max())
    return err <= max(2.0 * noise, 1e-3 * float(plain.abs().max()))


@pytest.mark.parametrize("n", [1, 700, 5000])
def test_mlp_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    uv = torch.rand((n, 2), generator=gen, device=cuda)
    emb = mk.pad_embedding(uv, 10, dtype=torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    for x, multires in ((emb, None), (uv, 10)):
        assert _agrees(mk.mlp_fwd_kernel(wflat, bflat, x, multires),
                       mk.fused_nerf2d_plain(ws, bs, x, multires, bf),
                       mk.fused_nerf2d_plain(ws, bs, x, multires, f32))
    g = torch.randn((n, 3), generator=gen, device=cuda)
    dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
    rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf)
    fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, f32)
    for a, b, c in zip(dws + dbs, rws + rbs, fws + fbs):
        assert _agrees(a, b, c)
    again = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs,
                                                 again[0] + again[1]))


@pytest.mark.parametrize("label,n", [("slice", 448 * 448),
                                     ("canvas", 960 * 640)])
def test_mlp_bwd_kernel_at_main_path_sizes(cuda, label, n):
    """K2 at the step's backward slice and at the whole canvas, from the
    precomputed embedding and from uv: every dW and db within the limit of
    the plain bf16 version, and two runs bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    uv = torch.rand((n, 2), generator=gen, device=cuda)
    emb = mk.pad_embedding(uv, 10, dtype=torch.bfloat16)
    g = torch.randn((n, 3), generator=gen, device=cuda) * 1e-2
    for x, multires in ((emb, None), (uv, 10)):
        before = _build.launch_counts["mlp_bwd"]
        dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, x, g, multires)
        assert _build.launch_counts["mlp_bwd"] == before + 1
        again = mk.mlp_bwd_kernel(wflat, bflat, x, g, multires)
        assert all(torch.equal(a, b) for a, b in zip(dws + dbs,
                                                     again[0] + again[1]))
        rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, multires,
                                             torch.bfloat16)
        fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, multires,
                                             torch.float32)
        for i, (a, b, c) in enumerate(zip(dws + dbs, rws + rbs, fws + fbs)):
            assert _agrees(a, b, c), (label, multires, i)


def test_mlp_fwd_kernel_takes_the_texture_lattice(cuda):
    """prepare_sds queries the MLP on the 1024^2 UV lattice: 2^20 points."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    uv = uv_lattice(1024, device=cuda)
    assert _agrees(mk.mlp_fwd_kernel(wflat, bflat, uv, 10),
                   mk.fused_nerf2d_plain(ws, bs, uv, 10, torch.bfloat16),
                   mk.fused_nerf2d_plain(ws, bs, uv, 10, torch.float32))


@pytest.mark.parametrize("label,n", [("canvas", 960 * 640),
                                     ("slice", 448 * 448), ("ragged", 1000),
                                     ("lattice", 1024 * 1024)])
def test_mlp_fwd_kernel_at_main_path_sizes(cuda, label, n):
    """K1 at the step's canvas and backward slice, a count off its 512-point
    cluster tile, and the 1024^2 lattice of prepare_sds, from uv and from
    the precomputed embedding; two runs bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    uv = (uv_lattice(1024, device=cuda) if label == "lattice"
          else torch.rand((n, 2), generator=gen, device=cuda))
    emb = mk.pad_embedding(uv, 10, dtype=torch.bfloat16)
    for x, multires in ((emb, None), (uv, 10)):
        before = _build.launch_counts["mlp_fwd"]
        got = mk.mlp_fwd_kernel(wflat, bflat, x, multires)
        assert _build.launch_counts["mlp_fwd"] == before + 1
        assert torch.equal(got, mk.mlp_fwd_kernel(wflat, bflat, x, multires))
        assert _agrees(got, mk.fused_nerf2d_plain(ws, bs, x, multires,
                                                  torch.bfloat16),
                       mk.fused_nerf2d_plain(ws, bs, x, multires,
                                             torch.float32))


def test_fused_entry_points_launch_the_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mlp = NeRF2D(generator=gen, device=cuda)
    uv = torch.rand((333, 2), generator=gen, device=cuda)
    before = dict(_build.launch_counts)
    mk.fused_nerf2d(mlp, uv, 10, compute_dtype=torch.bfloat16).sum().backward()
    assert _build.launch_counts["mlp_fwd"] == before["mlp_fwd"] + 1
    assert _build.launch_counts["mlp_bwd"] == before["mlp_bwd"] + 1
    assert all(torch.isfinite(p.grad).all() for p in mlp.parameters())
    with pytest.raises(ValueError, match="bf16"):
        mk.fused_nerf2d(mlp, uv, 10, compute_dtype=torch.float32)


# (B, H, Sq, Skv, Se): ragged shapes, the bootstrap's (64^2 and 32^2 tokens),
# tails of 1, 16 and BN - 1 = 127 keys in each source, Sq off the 128- and
# 192-row query tiles, and the SD2-inpaint UNet's on the Zero123++ canvas
# (generate's inpaint steps: a 120x80 latent, 9600 tokens, CFG batch 2)
FLASH_CASES = [(2, 3, 777, 1234, 0), (2, 3, 777, 1234, 301), (2, 3, 64, 64, 0),
               (2, 3, 1, 1025, 63), (2, 5, 4096, 4096, 0),
               (2, 10, 1024, 1024, 0), (1, 2, 300, 129, 16),
               (1, 2, 130, 144, 255), (1, 2, 257, 255, 129),
               (2, 5, 9600, 9600, 0)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B,H,sq,skv,se", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, B, H, sq, skv, se, strided):
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + se)

    def rnd(s):
        if strided:  # (B, H, S, 64) views of (B, S, H, 64), as layers pass
            return torch.randn((B, s, H, 64), generator=gen, device=cuda,
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
        return torch.randn((B, H, s, 64), generator=gen, device=cuda,
                           dtype=torch.bfloat16)

    args = (rnd(sq), rnd(skv), rnd(skv)) + (
        (rnd(se), rnd(se)) if se else (None, None))
    key = "flash_attn_two_source" if se else "flash_attn_single"
    before = _build.launch_counts[key]
    out = att.flash_attention(*args)
    assert _build.launch_counts[key] == before + 1
    assert out.shape == args[0].shape and torch.isfinite(out.float()).all()
    assert torch.equal(out, att.flash_attention(*args))
    plain = att.flash_attention_plain(*args)
    limit = attention_limit(torch, *args, plain)
    assert attention_ratio(torch, out, plain, limit) <= 1.0
    keys = skv + se
    pad = sum(-n % att.KV_TILE for n in (skv, se) if n)
    for fault in ATTENTION_FAULTS:
        bad = planted_attention(torch, att.flash_attention, *args, fault,
                                att.KV_TILE)
        if bad is not None and (fault != "tail" or pad >= 0.02 * keys):
            assert attention_ratio(torch, bad, plain, limit) > 1.0, fault


@pytest.mark.parametrize("block_m", att.BLOCK_M)
def test_flash_attention_query_tiles_match_plain(cuda, block_m):
    gen = torch.Generator(device=cuda).manual_seed(block_m)
    args = [torch.randn((2, s, 3, 64), generator=gen, device=cuda,
                        dtype=torch.bfloat16).permute(0, 2, 1, 3)
            for s in (777, 1234, 1234, 301, 301)]
    out = att.flash_attention(*args, block_m)
    plain = att.flash_attention_plain(*args)
    assert attention_ratio(torch, out, plain,
                           attention_limit(torch, *args, plain)) <= 1.0


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        att.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="64"):
        w = torch.zeros((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
        att.flash_attention(w, w, w)


@pytest.mark.parametrize("B,H,sq,skv,strided", [
    (1, 24, 2912, 2912, True), (1, 3, 777, 1234, True),
    (2, 2, 130, 144, False)])
def test_flash_attention_at_head_dim_128_matches_plain(cuda, B, H, sq, skv,
                                                       strided):
    """K3 at FLUX.1 Depth's head dim: its joint attention (24 heads over
    2,912 tokens), ragged tails, contiguous and strided inputs."""
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + 128)

    def rnd(s):
        if strided:
            return torch.randn((B, s, H, 128), generator=gen, device=cuda,
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
        return torch.randn((B, H, s, 128), generator=gen, device=cuda,
                           dtype=torch.bfloat16)

    args = (rnd(sq), rnd(skv), rnd(skv), None, None)
    before = _build.launch_shapes[("flash_attn_single", B, H, sq, skv, 0,
                                   128)]
    out = att.flash_attention(*args)
    assert _build.launch_shapes[("flash_attn_single", B, H, sq, skv, 0,
                                 128)] == before + 1
    assert out.shape == args[0].shape and torch.isfinite(out.float()).all()
    assert torch.equal(out, att.flash_attention(*args))
    plain = att.flash_attention_plain(*args)
    limit = attention_limit(torch, *args, plain)
    assert attention_ratio(torch, out, plain, limit) <= 1.0
    pad = -skv % att.KV_TILE
    for fault in ("scale", "tail"):
        bad = planted_attention(torch, att.flash_attention, *args, fault,
                                att.KV_TILE)
        if bad is not None and (fault != "tail" or pad >= 0.02 * skv):
            assert attention_ratio(torch, bad, plain, limit) > 1.0, fault


def test_head_dim_128_refuses_a_second_source_and_a_192_row_tile(cuda):
    q = torch.zeros((1, 2, 300, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="second KV source"):
        att.flash_attention(q, q, q, q, q)
    with pytest.raises(RuntimeError, match="flash_attn_fwd"):
        att.flash_attention(q, q, q, None, None, 192)
    with pytest.raises(ValueError, match="head dim 96"):
        w = torch.zeros((1, 1, 8, 96), device=cuda, dtype=torch.bfloat16)
        att.flash_attention(w, w, w)


def _faces(cuda, shape):
    """(fvz, fvi) of the 7 fixed views of the torus, or of a 50,880-face
    UV sphere (0.6 across, as the paint path normalizes) on the front
    view, or of a 500,000-face one."""
    cfg = config_from_dict({"guide": {"shape_path": "shapes/torus.obj"}})
    mm = TexturedMeshModel(cfg.guide, device=cuda)
    th, ph, r = view_angles(cfg.render)
    if shape == "torus":
        _, fvc, fvi, _ = mm.project(th, ph, r)
    else:
        v, f = (uv_sphere(160, 160)[:2] if shape == "sphere"
                else numpy_uv_sphere(501, 500))
        v = torch.from_numpy(v * 0.6).to(cuda)
        v[:, 1] += 0.25
        _, fvc, fvi, _ = mm.renderer.project(
            v, torch.from_numpy(f).to(cuda), th[:1], ph[:1], r[:1], 0.25)
    return fvc[..., 2].contiguous(), fvi.contiguous()


def _raster_case(cuda, case):
    """(fvz, fvi, H, W) of one K5 card case."""
    fvz, fvi = _faces(cuda, "torus" if case.startswith("torus") else case)
    views, H, W = {"torus7": (7, 1200, 1200), "sphere": (1, 1200, 1200),
                   "torus2_ragged": (2, 777, 1234),
                   "sphere500k": (1, 384, 384),
                   "torus2_whole_frame": (2, 512, 512),
                   "torus2_off_screen": (2, 512, 512),
                   "torus2_degenerate": (2, 256, 256),
                   "torus2_8x8": (2, 8, 8)}[case]
    fvz, fvi = fvz[:views].clone(), fvi[:views].clone()
    gen = torch.Generator(device=cuda).manual_seed(5)
    if case == "torus2_whole_frame":  # behind the torus, over every pixel
        big = torch.tensor([[-3.0, -3.0], [3.0, -3.0], [0.0, 4.0]],
                           device=cuda)
        fvi = torch.cat([fvi, big.expand(views, 1, 3, 2)], 1)
        fvz = torch.cat([fvz, torch.full((views, 1, 3), -50.0,
                                         device=cuda)], 1)
    elif case == "torus2_off_screen":  # every other face shifted by +-1.2
        shift = (torch.randint(0, 2, fvi.shape[:2] + (1, 2), generator=gen,
                               device=cuda) * 2 - 1) * 1.2
        fvi[:, ::2] += shift[:, ::2]
    elif case == "torus2_degenerate":  # a repeated vertex: den is 0
        fvi[:, :, 2] = fvi[:, :, 0]
    return fvz.contiguous(), fvi.contiguous(), H, W


@pytest.mark.parametrize("case", [
    "torus7", "sphere", "torus2_ragged", "sphere500k", "torus2_whole_frame",
    "torus2_off_screen", "torus2_degenerate", "torus2_8x8"])
def test_raster_kernel_matches_plain(cuda, case):
    fvz, fvi, H, W = _raster_case(cuda, case)
    views, F = fvz.shape[:2]
    before = _build.launch_counts["raster"]
    idx, bary = rk.rasterize_geometry(fvz, fvi, H, W)
    assert _build.launch_counts["raster"] == before + 1
    again = rk.rasterize_geometry_kernel(fvz, fvi, H, W)
    assert torch.equal(idx, again[0]) and torch.equal(bary, again[1])
    p_idx, p_bary = rasterize_geometry(fvz, fvi, H, W,
                                       face_chunk=64 if F < 100_000 else 1024)
    a = rk.raster_agreement(idx, bary, p_idx, p_bary, fvz)
    assert rk.agreement_ok(a), a
    if case == "torus2_degenerate":
        assert a["covered"] == 0 and bool((idx == -1).all())
    elif case == "torus2_whole_frame":
        assert bool((idx >= 0).all()) and bool((idx == F - 1).any())
    elif case != "torus2_8x8":
        assert a["covered"] > 0.02 * views * H * W
    if case == "torus7":
        ranges = rk.tile_ranges(rk.face_records(fvz, fvi)[1], H, W)
        for fz, fi, rg in ((-fvz, fvi, ranges),
                           (fvz[:, :-64], fvi[:, :-64], ranges[:, :-64]),
                           (fvz, fvi, shrunk_ranges(ranges))):
            b = rk.raster_agreement(*binned_plain(torch, fz, fi, H, W, rg),
                                    p_idx, p_bary, fvz)
            assert not rk.agreement_ok(b), b


def _eval_faces(cuda, case):
    """(fvz, fvi, H, W) of the eval path's K5 calls on the torus at the
    default config: one turntable frame (radius x 1.2, base_theta), the
    view-consistency metric's 6 target views at 192^2, and the UV charts
    rasterized at the 1024^2 texture with every z 1."""
    from contexture_nerf_tpu_torch.training.views_dataset import ViewsDataset

    cfg = config_from_dict({"guide": {"shape_path": "shapes/torus.obj"}})
    mm = TexturedMeshModel(cfg.guide, device=cuda)
    if case == "turntable":
        p = ViewsDataset(cfg.render, size=100).poses()[37]
        _, fvc, fvi, _ = mm.project([p["theta"]], [p["phi"]], [p["radius"]])
        return fvc[..., 2].contiguous(), fvi.contiguous(), 1024, 1024
    if case == "metric_views":
        th, ph, r = view_angles(cfg.render)
        _, fvc, fvi, _ = mm.project(th[1:], ph[1:], r[1:])
        return fvc[..., 2].contiguous(), fvi.contiguous(), 192, 192
    fvi = (mm.face_attributes * 2.0 - 1.0).contiguous()
    return torch.ones(fvi.shape[:-1], device=cuda), fvi, 1024, 1024


@pytest.mark.parametrize("case", ["turntable", "metric_views", "uv_space"])
def test_raster_kernel_at_the_eval_shapes_is_bit_identical(cuda, case):
    """The eval path's new K5 shapes: bit for bit the plain version (the
    UV-space raster's z ties included: both take the lowest face index)."""
    fvz, fvi, H, W = _eval_faces(cuda, case)
    idx, bary = rk.rasterize_geometry_kernel(fvz, fvi, H, W)
    p_idx, p_bary = rasterize_geometry(fvz, fvi, H, W)
    assert torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
    assert int((idx >= 0).sum()) > 0.02 * idx.numel()


def test_mlp_fwd_kernel_at_the_metric_views(cuda):
    """The view-consistency metric queries the MLP at the UVs of its 6
    views at 192^2 (background pixels included)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    cfg = config_from_dict({"guide": {"shape_path": "shapes/torus.obj"}})
    mm = TexturedMeshModel(cfg.guide, device=cuda)
    th, ph, r = view_angles(cfg.render)
    uv = mm.render_geometry(th[1:], ph[1:], r[1:], dims=(192, 192)
                            ).uv_features.reshape(-1, 2).contiguous()
    assert uv.shape[0] == 6 * 192 * 192
    assert _agrees(mk.mlp_fwd_kernel(wflat, bflat, uv, 10),
                   mk.fused_nerf2d_plain(ws, bs, uv, 10, torch.bfloat16),
                   mk.fused_nerf2d_plain(ws, bs, uv, 10, torch.float32))


@pytest.mark.parametrize("case", ["torus7", "torus2_off_screen",
                                  "torus2_degenerate", "non_finite"])
def test_raster_setup_matches_face_records(cuda, case):
    """The setup kernel's records equal `face_records` and its pixel
    ranges `pixel_ranges` (torch.equal; NaN records compared as equal where
    both are NaN)."""
    fvz, fvi, H, W = _raster_case(
        cuda, "torus2_ragged" if case == "non_finite" else case)
    if case == "non_finite":
        fvi[0, 3, 1, 0] = float("inf")
        fvi[1, 7, 2, 1] = float("nan")
        fvi[0, 9, 0, 0] = 3e38  # finite, far off the frame
    rec, ranges, ntiles = rk.face_setup(fvz, fvi, H, W)
    rec_p, box = rk.face_records(fvz, fvi)
    torch.testing.assert_close(rec, rec_p, rtol=0, atol=0, equal_nan=True)
    if case != "non_finite":
        assert torch.equal(rec, rec_p)
    assert torch.equal(ranges, rk.pixel_ranges(box, H, W))
    assert torch.equal(ntiles, rk.range_tiles(rk.tile_ranges(box, H, W)))
    if case == "non_finite":
        assert int(ntiles[0, 3]) == int(ntiles[1, 7]) == 0


def test_raster_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros((1, 4, 3), device=cuda)
    with pytest.raises(ValueError, match="B, F, 3, 2"):
        rk.rasterize_geometry_kernel(z, torch.zeros((1, 4, 3), device=cuda),
                                     8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rasterize_geometry_kernel(z.cpu(), torch.zeros((1, 4, 3, 2)), 8, 8)


# (x shape, x dtype, out dtype, scale/bias dtype, eps, act): the bootstrap's
# UNet (64^2 latent; f32 residual stream in, bf16 out, bf16 parameters as
# the bf16 towers hold them) and 512^2 decoder, the SDS step's UNet
# (120x80) and canvas encoder (960x640), and ragged shapes off the 16-byte
# pack. Between them they take every path of K6's plan: one CTA, a
# cluster, a cluster whose shares overflow its shared memory, and the
# element-by-element path that keeps nothing on chip.
GN_CASES = [
    ((2, 320, 64, 64), torch.bfloat16, torch.bfloat16, torch.float32, 1e-5,
     True),
    ((2, 640, 32, 32), torch.float32, torch.bfloat16, torch.bfloat16, 1e-5,
     True),
    ((2, 1280, 8, 8), torch.bfloat16, torch.bfloat16, torch.float32, 1e-6,
     False),
    ((2, 2560, 8, 8), torch.float32, torch.bfloat16, torch.bfloat16, 1e-5,
     True),
    ((1, 128, 512, 512), torch.bfloat16, torch.bfloat16, torch.bfloat16,
     1e-6, True),
    ((1, 256, 512, 512), torch.bfloat16, torch.bfloat16, torch.bfloat16,
     1e-6, True),
    ((2, 320, 120, 80), torch.bfloat16, torch.bfloat16, torch.float32, 1e-5,
     True),
    ((1, 128, 960, 640), torch.bfloat16, torch.bfloat16, torch.bfloat16,
     1e-6, True),
    # the largest of generate's 960x640 decode: its last up block's first
    # resnet, 256 channels in
    ((1, 256, 960, 640), torch.bfloat16, torch.bfloat16, torch.bfloat16,
     1e-6, True),
    ((1, 96, 7, 13), torch.float32, torch.float32, torch.float32, 1e-5, True),
    ((2, 64, 5, 9), torch.bfloat16, torch.float32, torch.float32, 1e-6,
     False),
    ((1, 64, 33, 17), torch.float32, torch.bfloat16, torch.float32, 1e-5,
     True),
    ((1, 64, 129, 131), torch.float32, torch.float32, torch.float32, 1e-5,
     True),  # ragged and over a CTA's share: a cluster, element by element
]


def _gn_inputs(cuda, shape, dt, pdt):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = activations(torch, shape, dt, gen)
    C = shape[1]
    scale = (1 + 0.3 * torch.randn((C,), generator=gen, device=cuda)).to(pdt)
    bias = (0.2 * torch.randn((C,), generator=gen, device=cuda)).to(pdt)
    return x, scale, bias


@pytest.mark.parametrize("shape,dt,out_dt,pdt,eps,act", GN_CASES)
def test_groupnorm_kernel_matches_plain(cuda, shape, dt, out_dt, pdt, eps,
                                        act):
    x, scale, bias = _gn_inputs(cuda, shape, dt, pdt)
    args = (scale, bias, 32, eps, act, out_dt)
    before = _build.launch_counts["groupnorm"]
    got = gn.group_norm_silu(x, *args)
    assert _build.launch_counts["groupnorm"] == before + 1
    assert got.dtype == out_dt and torch.isfinite(got.float()).all()
    assert torch.equal(got, gn.group_norm_silu_kernel(x, *args))
    plain = gn.group_norm_silu_plain(x, *args)
    limit = groupnorm_limit(torch, x, scale, bias, 32, eps, act, plain)
    assert groupnorm_ratio(torch, got, plain, limit) <= 1.0
    if act and dt == torch.bfloat16:
        for fault in ("boundary", "no_silu", "chunk"):
            bad = planted_group_norm(torch, x, *args, fault)
            assert groupnorm_ratio(torch, bad, plain, limit) > 1.0, fault


def test_groupnorm_cases_take_every_path(cuda):
    paths = set()
    for shape, dt, _, pdt, _, _ in GN_CASES:
        x, _, _ = _gn_inputs(cuda, shape, dt, pdt)
        paths.add(gn.kernel_plan(x).path)
    assert {"cta", "cluster", "cluster+overflow", "cta+overflow"} <= paths, \
        paths
    x, _, _ = _gn_inputs(cuda, (1, 64, 129, 131), torch.float32,
                         torch.float32)
    p = gn.kernel_plan(x)
    assert not p.vec and p.cluster > 1, p


def test_groupnorm_kernel_gradients_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = activations(torch, (2, 64, 12, 10), torch.float32, gen)
    scale = 1 + 0.3 * torch.randn((64,), generator=gen, device=cuda)
    bias = 0.2 * torch.randn((64,), generator=gen, device=cuda)
    w = torch.randn((2, 64, 12, 10), generator=gen, device=cuda)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
        (fn(*ins, 32, 1e-5, True, torch.float32) * w).sum().backward()
        return [t.grad for t in ins]

    before = dict(_build.launch_counts)
    got = grads(gn.group_norm_silu)
    assert _build.launch_counts["groupnorm"] == before["groupnorm"] + 1
    assert _build.launch_counts["groupnorm_bwd"] == \
        before["groupnorm_bwd"] + 1
    plain = gn.group_norm_silu_bwd_plain(x, scale, bias, w, 32, 1e-5, True)
    limit = groupnorm_bwd_limit(torch, x, scale, bias, w, 32, 1e-5, True,
                                plain)
    assert groupnorm_bwd_ratio(torch, got, plain, limit) <= 1.0


def test_groupnorm_kernel_rejects_what_it_does_not_take(cuda):
    s = torch.ones(64, device=cuda)
    x = torch.zeros((1, 64, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x.transpose(2, 3), s, s)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn.group_norm_silu(x.half(), s, s)
    with pytest.raises(ValueError, match="multiple of groups"):
        gn.group_norm_silu(x[:, :40].contiguous(), s[:40], s[:40])
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_silu_kernel(x.cpu(), s.cpu(), s.cpu())


def _encoder_cases():
    seen = []
    for hw in ((448, 448), (960, 640)):
        for shape, act in vae_encoder_groupnorms(*hw):
            if (shape, act) not in seen:
                seen.append((shape, act))
    bf = torch.bfloat16
    return [(shape, act, bf, bf, (True, False, False), 0)
            for shape, act in seen]


# (x shape, act, x dtype, g dtype, gradients asked for, x's offset in
# elements from a 16-byte boundary): the VAE encoder's GroupNorms as the
# SDS step runs them (dx only), then every gradient, mixed dtypes, ragged
# groups (not whole 16-byte vectors) and a misaligned x
ALL = (True, True, True)
GN_BWD_CASES = _encoder_cases() + [
    ((2, 320, 24, 20), True, torch.bfloat16, torch.bfloat16, ALL, 0),
    ((2, 320, 24, 20), True, torch.float32, torch.float32, ALL, 0),
    ((2, 640, 32, 32), True, torch.float32, torch.bfloat16, ALL, 0),
    ((2, 320, 20, 24), False, torch.bfloat16, torch.float32, ALL, 0),
    ((1, 128, 480, 320), True, torch.bfloat16, torch.bfloat16,
     (False, True, True), 0),
    ((1, 96, 7, 13), True, torch.float32, torch.float32, ALL, 0),
    ((2, 64, 5, 9), False, torch.bfloat16, torch.bfloat16, ALL, 0),
    ((1, 64, 129, 131), True, torch.float32, torch.float32, ALL, 0),
    ((1, 128, 120, 80), True, torch.bfloat16, torch.bfloat16, ALL, 1),
]


def _gn_bwd_inputs(cuda, shape, dt, gdt, offset):
    x, scale, bias = _gn_inputs(cuda, shape, dt, dt)
    if offset:  # the same values, `offset` elements past an aligned start
        buf = torch.empty(x.numel() + offset, dtype=dt, device=cuda)
        buf[offset:].copy_(x.flatten())
        x = buf[offset:].view(shape)
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    return x, scale, bias, output_gradient(torch, x, gdt, gen)


@pytest.mark.parametrize("shape,act,dt,gdt,need,offset", GN_BWD_CASES)
def test_groupnorm_bwd_kernel_matches_plain(cuda, shape, act, dt, gdt, need,
                                            offset):
    x, scale, bias, g = _gn_bwd_inputs(cuda, shape, dt, gdt, offset)
    args = (32, 1e-6, act, need)
    before = _build.launch_counts["groupnorm_bwd"]
    got = gn.group_norm_silu_bwd_kernel(x, scale, bias, g, *args)
    assert _build.launch_counts["groupnorm_bwd"] == before + 1
    again = gn.group_norm_silu_bwd_kernel(x, scale, bias, g, *args)
    plain = gn.group_norm_silu_bwd_plain(x, scale, bias, g, *args)
    for a, b, p in zip(got, again, plain):
        assert (a is None) == (b is None) == (p is None)
        if a is not None:
            assert a.dtype == p.dtype and a.shape == p.shape
            assert torch.isfinite(a.float()).all() and torch.equal(a, b)
    limit = groupnorm_bwd_limit(torch, x, scale, bias, g, 32, 1e-6, act,
                                plain)
    assert groupnorm_bwd_ratio(torch, got, plain, limit) <= 1.0
    if act and need[0] and dt == torch.bfloat16:
        for fault in BWD_FAULTS:
            bad = planted_group_norm_bwd(torch, x, scale, bias, g, 32, 1e-6,
                                         act, fault)
            assert groupnorm_ratio(torch, bad, plain[0], limit[0]) > 1.0, \
                fault


def test_groupnorm_bwd_cases_take_every_path(cuda):
    paths = set()
    for shape, _, dt, gdt, _, offset in GN_BWD_CASES:
        x, _, _, g = _gn_bwd_inputs(cuda, shape, dt, gdt, offset)
        p = gn.bwd_kernel_plan(x, g)
        assert p.vec == (offset == 0 and shape not in (
            (1, 96, 7, 13), (2, 64, 5, 9), (1, 64, 129, 131))), (shape, p)
        paths.add(p.path)
    assert {"cta", "cluster", "cluster+overflow", "cta+overflow"} <= paths, \
        paths


def test_groupnorm_autograd_takes_a_strided_gradient(cuda):
    """A permuted view after the GroupNorm hands its backward a
    non-contiguous gradient, as the VAE's mid attention does."""
    x, scale, bias, _ = _gn_bwd_inputs(cuda, (1, 512, 12, 10),
                                       torch.bfloat16, torch.bfloat16, 0)
    w = torch.randn((1, 12, 10, 512), device=cuda)

    def grad(fn):
        xx = x.clone().requires_grad_()
        y = fn(xx, scale, bias, 32, 1e-6, False, torch.bfloat16)
        (y.permute(0, 2, 3, 1).float() * w).sum().backward()
        return xx.grad

    got, ref = grad(gn.group_norm_silu), grad(gn.group_norm_silu_plain)
    g = (w.permute(0, 3, 1, 2)).to(torch.bfloat16)
    plain = gn.group_norm_silu_bwd_plain(x, scale, bias, g, 32, 1e-6, False)
    limit = groupnorm_bwd_limit(torch, x, scale, bias, g, 32, 1e-6, False,
                                plain)
    assert groupnorm_ratio(torch, got, plain[0], limit[0]) <= 1.0
    assert groupnorm_ratio(torch, ref, plain[0], limit[0]) <= 1.0


def test_groupnorm_bwd_kernel_takes_a_strided_g(cuda):
    """A strided g is copied contiguous inside the wrapper: the same
    results, bit for bit, as from its contiguous copy."""
    x, scale, bias, g = _gn_bwd_inputs(cuda, (1, 128, 24, 20),
                                       torch.bfloat16, torch.bfloat16, 0)
    strided = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous() and torch.equal(strided, g)
    args = (32, 1e-6, True, ALL)
    for a, b in zip(gn.group_norm_silu_bwd_kernel(x, scale, bias, strided,
                                                  *args),
                    gn.group_norm_silu_bwd_kernel(x, scale, bias, g, *args)):
        assert torch.equal(a, b)


def test_groupnorm_bwd_kernel_rejects_what_it_does_not_take(cuda):
    s = torch.ones(64, device=cuda)
    x = torch.zeros((1, 64, 8, 8), device=cuda)
    g = torch.ones_like(x)
    bwd = gn.group_norm_silu_bwd_kernel
    with pytest.raises(ValueError, match="contiguous"):
        bwd(x.transpose(2, 3), s, s, g)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bwd(x.half(), s, s, g)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bwd(x, s, s, g.half())
    with pytest.raises(ValueError, match="multiple of groups"):
        bwd(x[:, :40].contiguous(), s[:40], s[:40], g[:, :40].contiguous())
    with pytest.raises(ValueError, match="shaped like x"):
        bwd(x, s, s, g[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        bwd(x.cpu(), s.cpu(), s.cpu(), g.cpu())


@pytest.fixture(scope="module")
def k7_cases():
    """chip_smoke.texture_cases, made once: the exact path's 6 x 1200^2
    views of the torus and 1024^2 texture (bilinear, nearest), a ragged
    2 x 777 x 1234 with a texture a view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels on "
                    "the card")
    return texture_cases(torch, 0)


@pytest.mark.parametrize("case", range(3))
def test_texture_kernels_match_plain(k7_cases, case):
    """K7's forward equals masked_sample_plain bit for bit; its backward
    equals the plain segment sum on the CPU bit for bit, sits within
    k7_limit of autograd through the plain gathers, runs bit-identically
    twice and writes the texture's layout; the planted faults miss the
    limit."""
    _, uv, mask, tex, mode, _ = k7_cases[case]
    plan = tx.texture_plan(uv, mask, tuple(tex.shape[2:]), mode,
                           tex.shape[0])
    assert torch.equal(tx.texture_fwd_kernel(uv, mask, tex, mode),
                       tx.masked_sample_plain(uv, mask, tex, mode))
    g = torch.randn((uv.shape[0], 3) + tuple(uv.shape[1:3]),
                    generator=torch.Generator(device=uv.device).manual_seed(
                        case), device=uv.device)
    got = tx.texture_bwd_kernel(plan, g, tex)
    assert torch.equal(got, tx.texture_bwd_kernel(plan, g, tex))
    assert got.stride() == tex.stride()
    cpu_plan = tx.TexturePlan(*(t.cpu() for t in plan[:3]), *plan[3:])
    assert torch.equal(got.cpu(), tx.texture_bwd_plain(cpu_plan, g.cpu(),
                                                       tex.cpu()))
    t = tex.detach().clone().requires_grad_(True)
    tx.masked_sample_plain(uv, mask, t, mode).backward(g)
    limit = k7_limit(torch, plan, g)
    assert bool(((got - t.grad).abs() <= limit).all())
    for fault in K7_FAULTS:
        bad = planted_k7_bwd(torch, plan, g, tex, fault)
        assert not bool(((bad - t.grad).abs() <= limit).all()), fault


def test_texture_autograd_takes_k7(k7_cases):
    """A CUDA texture that needs a gradient goes through K7 both ways, with
    a plan built for the call; one that does not launches the forward
    alone."""
    _, uv, mask, tex, mode, _ = k7_cases[2]
    before = dict(_build.launch_counts)
    t = tex.detach().clone().requires_grad_(True)
    out = tx.sample_texture_masked(uv, mask, t, mode)
    g = torch.ones_like(out)
    out.backward(g)
    plan = tx.texture_plan(uv, mask, tuple(tex.shape[2:]), mode,
                           tex.shape[0])
    assert torch.equal(t.grad, tx.texture_bwd_kernel(plan, g, tex))
    with torch.no_grad():
        tx.sample_texture_masked(uv, mask, t, mode)
    assert _build.launch_counts["texture_fwd"] == before["texture_fwd"] + 2
    assert _build.launch_counts["texture_bwd"] == before["texture_bwd"] + 2


def test_texture_kernels_reject_what_they_do_not_take(cuda):
    uv = torch.rand((2, 5, 7, 2), device=cuda)
    mask = torch.ones((2, 1, 5, 7), device=cuda)
    tex = torch.rand((1, 3, 8, 6), device=cuda)
    fwd = tx.texture_fwd_kernel
    with pytest.raises(ValueError, match="float32"):
        fwd(uv, mask, tex.double())
    with pytest.raises(ValueError, match="float32"):
        fwd(uv.bfloat16(), mask, tex)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(uv, mask.cpu(), tex)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(uv.transpose(1, 2), mask.transpose(2, 3), tex)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(uv, mask.transpose(2, 3), tex)
    with pytest.raises(ValueError, match="texture must be"):
        fwd(uv, mask, tex[:, :2])
    plan = tx.texture_plan(uv, mask, (8, 6))
    g = torch.ones((2, 3, 5, 7), device=cuda)
    bwd = tx.texture_bwd_kernel
    with pytest.raises(ValueError, match="float32"):
        bwd(plan, g.double(), tex)
    with pytest.raises(ValueError, match="plan's"):
        bwd(plan, g[:, :, :4], tex)
    with pytest.raises(ValueError, match="CUDA"):
        bwd(tx.TexturePlan(*(t.cpu() for t in plan[:3]), *plan[3:]), g, tex)
    with pytest.raises(ValueError, match="int32"):
        bwd(plan._replace(pixel=plan.pixel.long()), g, tex)


def test_exact_step_launches_k7_once_each(cuda, tmp_path):
    """One exact_lattice_render step (full-width towers, the torus's views
    at 64^2, a 64^2 texture) launches K7's forward and backward once each,
    and K3, K4, K6 and gn_bwd as its census counts."""
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = config_from_dict({
        "log": {"exp_root": str(tmp_path)},
        "render": {"train_grid_size": 64, "eval_grid_size": 64},
        "guide": {"text": "k7", "shape_path": "shapes/torus.obj",
                  "texture_resolution": 64},
        "optim": {"seed": 0, "exact_lattice_render": True}})
    trainer, _ = tr.build_sds_trainer(cfg, device=cuda, skip_bootstrap=True)
    assert trainer.texture_plan.kept > 0
    trainer.step(500)  # the first step's allocations
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with census() as c:
        trainer.step(500)
        torch.cuda.synchronize()
    assert _build.launch_counts["texture_fwd"] == 1
    assert _build.launch_counts["texture_bwd"] == 1
    assert c.counts["groupnorm"] > c.counts["groupnorm_bwd"] > 0
    assert not c.unmatched(_build.launch_counts)


def test_int_mm_shape_rules(cuda):
    """ops/quant.py's int8 product on the card: fewer than 17 rows are
    zero-padded (exact), K or N not a multiple of 8 raises."""
    from contexture_nerf_tpu_torch.ops import quant

    a = torch.randint(-127, 128, (5, 32), dtype=torch.int8, device=cuda)
    b = torch.randint(-127, 128, (16, 32), dtype=torch.int8, device=cuda).t()
    got = quant.int_mm(a, b)
    assert torch.equal(got.cpu(), a.cpu().int() @ b.cpu().int())
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(a[:, :30], b[:30])
