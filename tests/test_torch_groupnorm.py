"""The port's GroupNorm(+SiLU) (contexture_nerf_tpu_torch/ops/groupnorm.py)
against the JAX reference on the CPU: the plain version against
`group_norm_silu_reference` and the Pallas kernel in interpret mode (both
channels-last, so the inputs are transposed), and the gradients against
`jax.grad` of the reference's custom-VJP `group_norm_silu`. Then what the
CPU can check of the kernel's dispatch and limits: a CPU tensor takes the
plain version and launches nothing; K6's plan covers every group at every
GroupNorm signature of the main path (the towers run on the meta device at
full width); a torch emulation of K6's reduction order (per-thread sums of
16-byte vectors, warp shuffles, warps in order, then the cluster's ranks in
order, with the on-chip/overflow split) matches the reference and the Pallas
kernel in interpret mode; and the limits chip_smoke.py holds K6 to pass a
plain run whose statistics were summed in another order but reject the
three planted faults. The backward kernel's specification, the closed form
`group_norm_silu_bwd_plain`, is held to autograd through the plain version;
gn_bwd's plan covers every group of the VAE encoder's 22 GroupNorms in the
SDS step and ragged ones; a torch emulation of gn_bwd's partition (ranks'
chunks, their sums in rank order, the per-channel partials and the
wrapper's sum of them) matches the closed form; and chip_smoke.py's
backward limits pass sums taken in another order and reject its planted
faults.

Tolerances: f32 output within 2e-6 of max(1, |ref|) (the two sum the
statistics in other orders); bf16 output within one bf16 ulp of the
reference's magnitude (plus 1e-6), since f32 values that differ in the
last bits can round to neighbouring bf16 values.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (BWD_FAULTS, GN_SHAPES, STEP_CANVAS, STEP_SLICE,
                        activations, closed_form_bwd, groupnorm_bwd_limit,
                        groupnorm_bwd_ratio, groupnorm_limit,
                        groupnorm_ratio, library_bwd, output_gradient,
                        planted_group_norm, planted_group_norm_bwd,
                        vae_encoder_groupnorms)
from contexture_nerf_tpu.ops.groupnorm import (group_norm_silu as j_gn,
                                               group_norm_silu_pallas,
                                               group_norm_silu_reference)
from contexture_nerf_tpu_torch.diffusion.controlnet import ControlNet
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Decoder, Encoder,
                                                     VAEConfig)
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import groupnorm as gn

J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (B, C, H, W, act, x dtype, out dtype, eps); H x W ragged (not a multiple
# of the 16-byte pack) in three of them
CASES = [
    (2, 64, 6, 8, True, torch.float32, torch.float32, 1e-5),
    (1, 96, 7, 13, False, torch.float32, torch.float32, 1e-6),
    (2, 128, 5, 5, True, torch.bfloat16, torch.bfloat16, 1e-6),
    (1, 64, 9, 11, False, torch.float32, torch.bfloat16, 1e-5),
    (2, 64, 3, 7, True, torch.bfloat16, torch.float32, 1e-5),
]


def _inputs(B, C, H, W, dt, seed=0):
    rng = np.random.default_rng(seed)
    mu = 0.5 + 0.5 * rng.standard_normal((1, C, 1, 1))
    x = (rng.standard_normal((B, C, H, W)) * (0.5 + rng.random((1, C, 1, 1)))
         + mu).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C)).astype(np.float32)
    xt = torch.from_numpy(x).to(dt)
    # the reference sees exactly the values the port sees
    xj = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1), J_DT[dt])
    return xt, torch.from_numpy(scale), torch.from_numpy(bias), xj, scale, \
        bias


def _nchw(y):
    return np.asarray(jnp.asarray(y, jnp.float32)).transpose(0, 3, 1, 2)


def _assert_close(got, ref, out_dt):
    got = got.float().numpy()
    if out_dt == torch.float32:
        tol = 2e-6 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    else:
        a = np.maximum(np.abs(ref), 2.0 ** -126)
        ulp = np.exp2(np.floor(np.log2(a)) - 7)
        np.testing.assert_array_less(np.abs(got - ref), ulp + 1e-6)


@pytest.mark.parametrize("B,C,H,W,act,dt,out_dt,eps", CASES)
def test_plain_matches_reference_and_pallas(B, C, H, W, act, dt, out_dt,
                                            eps):
    x, s, b, xj, sj, bj = _inputs(B, C, H, W, dt)
    got = gn.group_norm_silu(x, s, b, 32, eps, act, out_dt)
    assert got.dtype == out_dt and got.shape == x.shape
    ref = group_norm_silu_reference(xj, sj, bj, 32, eps, act, J_DT[out_dt])
    pal = group_norm_silu_pallas(xj, sj, bj, 32, eps, act, J_DT[out_dt],
                                 interpret=True)
    _assert_close(got, _nchw(ref), out_dt)
    _assert_close(got, _nchw(pal), out_dt)


@pytest.mark.parametrize("act", [True, False])
def test_gradients_match_reference(act):
    x, s, b, xj, sj, bj = _inputs(2, 64, 6, 5, torch.float32, seed=1)
    w = np.random.default_rng(2).standard_normal((2, 64, 6, 5)).astype(
        np.float32)

    def ref_loss(xx, ss, bb):
        y = j_gn(xx, ss, bb, 32, 1e-5, act, jnp.float32)
        return jnp.sum(y * jnp.asarray(w.transpose(0, 2, 3, 1)))

    gx, gs, gb = jax.grad(ref_loss, (0, 1, 2))(xj, jnp.asarray(sj),
                                               jnp.asarray(bj))
    ins = [t.clone().requires_grad_() for t in (x, s, b)]
    y = gn.group_norm_silu(*ins, 32, 1e-5, act, torch.float32)
    (y * torch.from_numpy(w)).sum().backward()
    # the scale and bias gradients sum 60 products a channel: f32
    # reassociation noise, as the reference's own test allows
    np.testing.assert_allclose(ins[0].grad.numpy(), _nchw(gx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ins[1].grad.numpy(), np.asarray(gs), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(ins[2].grad.numpy(), np.asarray(gb), atol=1e-4,
                               rtol=0)


def test_cpu_takes_the_plain_version_and_launches_nothing():
    x, s, b, *_ = _inputs(1, 64, 4, 4, torch.float32)
    before = dict(_build.launch_counts)
    assert torch.equal(gn.group_norm_silu(x, s, b),
                       gn.group_norm_silu_plain(x, s, b))
    m = gn.GroupNormSiLU(64, 32, 1e-6, act=False)
    assert torch.equal(m(x), gn.group_norm_silu_plain(
        x, m.weight, m.bias, 32, 1e-6, False, torch.float32))
    assert _build.launch_counts == before
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_silu_kernel(x, s, b)


def _tower_signatures(monkeypatch, part):
    """{(x shape, x dtype): calls} of the GroupNorms of one main-path part
    at full width, bf16 towers run on the meta device (no memory, no
    arithmetic): the bootstrap's SD2-depth UNet call and 512^2 decode, the
    condition encode, and the SDS step's Zero123++ UNet write and read
    passes, its depth ControlNet, and the canvas and slice encodes."""
    from contexture_nerf_tpu_torch.diffusion import layers

    monkeypatch.setattr(gn, "group_norm_silu", lambda x, s, b, g, e, a, o:
                        torch.empty(x.shape, dtype=o or x.dtype,
                                    device=x.device))
    monkeypatch.setattr(layers, "attention", lambda q, k, v, extra_k=None,
                        extra_v=None: torch.empty_like(q))
    bf, sigs = torch.bfloat16, {}

    def hook(mod, inp):
        key = (tuple(inp[0].shape), inp[0].dtype)
        sigs[key] = sigs.get(key, 0) + 1

    def e(*shape):
        return torch.empty(shape, dtype=bf)

    with torch.device("meta"), torch.no_grad():
        if part in ("bootstrap UNet", "step UNet", "step ControlNet"):
            cfg = (UNetConfig.sd2_depth() if part == "bootstrap UNet"
                   else UNetConfig.zero123plus())
            tower = (ControlNet(cfg, bf) if part == "step ControlNet"
                     else UNet2DCondition(cfg, bf))
        elif part == "decode":
            tower = Decoder(VAEConfig.sd(), bf)
        else:
            tower = Encoder(VAEConfig.sd(), bf)
        tower.to(bf)  # as the teacher and the SD2-depth stack cast theirs
        for m in tower.modules():
            if isinstance(m, gn.GroupNormSiLU):
                m.register_forward_pre_hook(hook)
        t, ehs = torch.tensor([981]), e(2, 77, 1024)
        if part == "bootstrap UNet":
            tower(e(2, 5, 64, 64), t, ehs)
        elif part == "step UNet":  # the write pass, then the read pass
            ref = []
            tower(e(2, 4, 40, 40), t, ehs, ref_out=ref)
            tower(e(2, 4, 120, 80), t, ehs, ref_kv_list=ref)
        elif part == "step ControlNet":
            tower(e(2, 4, 120, 80), t, ehs, e(2, 3, 960, 640), 2.0)
        elif part == "decode":
            tower(e(1, 4, 64, 64))
        else:
            tower(e(1, 3, *{"condition encode": (320, 320),
                            "canvas encode": (960, 640),
                            "slice encode": (448, 448)}[part]))
    return sigs


def _check_plan(n, bg, itemsize, max_cluster):
    p = gn.plan(n, bg, itemsize, True, max_cluster)
    pack = 16 // itemsize
    assert p.vec == (n % pack == 0)
    assert 1 <= p.cluster <= max_cluster
    # equal chunks, none empty, none missing
    assert (p.cluster - 1) * p.chunk < n <= p.cluster * p.chunk
    assert 0 <= p.keep <= p.chunk and p.keep * itemsize <= gn.SMEM_CAP
    if p.vec:
        assert p.chunk % pack == 0 and p.keep % pack == 0
        # a group is kept whole on chip wherever the cluster can hold it
        if n * itemsize <= max_cluster * gn.SMEM_CAP:
            assert p.keep == p.chunk
    else:
        assert p.keep == 0
    assert p.path == ("cta" if p.cluster == 1 else "cluster") + (
        "+overflow" if p.keep < p.chunk else "")
    # every SM gets a CTA, unless a share is already at its smallest
    assert (bg * p.cluster >= gn.SMS or p.cluster == max_cluster
            or n * itemsize < 2 * p.cluster * gn.MIN_CTA_BYTES)
    return p


MAIN_PATH_PARTS = ["bootstrap UNet", "decode", "condition encode",
                   "step UNet", "step ControlNet", "canvas encode",
                   "slice encode"]


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("part", MAIN_PATH_PARTS)
def test_plan_covers_every_main_path_signature(monkeypatch, part,
                                               max_cluster):
    """K6's plan at every GroupNorm signature of the main path, for a card
    that holds clusters of 16 CTAs at full shared memory and for one that
    holds 8: every group covered once, on chip wherever it fits, and every
    signature a whole number of 16-byte vectors (the main path never takes
    the element-by-element path)."""
    sigs = _tower_signatures(monkeypatch, part)
    assert len(sigs) >= 4
    for (shape, dt), _ in sigs.items():
        bg = shape[0] * 32
        n = math.prod(shape) // bg
        itemsize = torch.empty((), dtype=dt).element_size()
        assert _check_plan(n, bg, itemsize, max_cluster).vec, shape


@pytest.mark.parametrize("label,shape,dt", [
    (label, shape, dt) for label, shape, dt, *_ in GN_SHAPES])
def test_plan_covers_the_kernel_phase_shapes(label, shape, dt):
    itemsize = 2 if dt == "bf16" else 4
    bg = shape[0] * 32
    _check_plan(math.prod(shape) // bg, bg, itemsize, gn.MAX_CLUSTER)


def test_plans_of_the_largest_groups():
    """The paths the design names: the 64^2 UNet groups in clusters of 2-4,
    the decoder's 0.5 M-element groups in 16 on chip and its 1 M-element
    ones in 16 with an overflow, as the step encoder's 2.46 M-element
    groups, the smallest in one CTA."""
    assert gn.plan(40960, 64, 2) == gn.Plan("cluster", 4, 10240, 10240, True)
    assert gn.plan(20480, 64, 2).cluster == 2
    assert gn.plan(2560, 64, 2).path == "cta"
    assert gn.plan(2 ** 19, 32, 2) == gn.Plan("cluster", 16, 32768, 32768,
                                              True)
    for n, chunk in ((2 ** 20, 65536), (4 * 960 * 640, 153600)):
        p = gn.plan(n, 32, 2)
        assert p.path == "cluster+overflow" and p.cluster == 16
        assert p.keep * 2 == gn.SMEM_CAP and p.chunk == chunk
    assert gn.plan(3 * 91, 32, 4).path == "cta+overflow"  # not whole vectors


def emulate_k6(x, scale, bias, groups, eps, act, out_dtype, p,
               threads=gn.THREADS):
    """csrc/groupnorm.cu's arithmetic in torch for plan p: rank r of a
    group's cluster owns units [r chunk, (r + 1) chunk) (16-byte vectors, or
    elements without vec), its first `keep` on chip; thread t sums the kept
    units t, t + T, ... then the overflow's in increasing order, each unit's
    elements in order (f32, up to FMA contraction of x*x); the 32 lanes of a
    warp add by xor shuffles (16, 8, 4, 2, 1), the warps' sums are added in
    warp order, the ranks' in rank order; then mean, E[x^2] - mean^2 and
    the elementwise chain in the plain version's order."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B * groups, -1)
    n = xf.shape[1]
    unit = 16 // x.element_size() if p.vec else 1
    nu, cu, ku = n // unit, p.chunk // unit, p.keep // unit
    tot = torch.zeros(B * groups, 2)
    for r in range(p.cluster):
        lo = min(r * cu, nu)
        hi = min(lo + cu, nu)
        kept = min(ku, hi - lo) if p.vec else 0
        per_thread = []
        for t in range(threads):
            us = list(range(t, kept, threads)) + list(
                range(kept + t, hi - lo, threads))
            per_thread.append([lo + u for u in us])
        steps = max(len(u) for u in per_thread)
        s = torch.zeros(B * groups, threads)
        q = torch.zeros(B * groups, threads)
        for i in range(steps):
            for k in range(unit):
                col = torch.tensor([us[i] * unit + k if i < len(us) else -1
                                    for us in per_thread])
                v = torch.where(col >= 0, xf[:, col.clamp(min=0)],
                                torch.zeros(()))
                s = s + v
                q = q + v * v
        for o in (16, 8, 4, 2, 1):
            perm = torch.arange(threads) ^ o
            s, q = s + s[:, perm], q + q[:, perm]
        t = torch.zeros(B * groups, 2)
        for w in range(threads // 32):
            t = t + torch.stack([s[:, 32 * w], q[:, 32 * w]], 1)
        tot = tot + t
    mean = (tot[:, 0] / n)[:, None]
    var = (tot[:, 1] / n)[:, None] - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean) * rstd).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if act:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.to(out_dtype)


def _small_plan(n, bg, itemsize, vec, cap, min_bytes, max_cluster,
                g_itemsize=None):
    """gn.plan (gn.bwd_plan with g_itemsize) with a shared memory of `cap`
    bytes a CTA and shares of at least `min_bytes`, so small inputs take
    the cluster and overflow paths."""
    old = gn.SMEM_CAP, gn.MIN_CTA_BYTES
    gn.SMEM_CAP, gn.MIN_CTA_BYTES = cap, min_bytes
    try:
        if g_itemsize is None:
            return gn.plan.__wrapped__(n, bg, itemsize, vec, max_cluster)
        return gn.bwd_plan.__wrapped__(n, bg, itemsize, g_itemsize, vec,
                                       max_cluster)
    finally:
        gn.SMEM_CAP, gn.MIN_CTA_BYTES = old


# (plan label, SMEM_CAP, MIN_CTA_BYTES, max cluster)
EMULATED_PLANS = [("as planned", None, None, 16),
                  ("cluster", 1 << 20, 64, 4),
                  ("cluster+overflow", 32, 16, 3),
                  ("cta+overflow", 128, 1 << 20, 1)]


@pytest.mark.parametrize("label,cap,min_bytes,max_cluster", EMULATED_PLANS)
@pytest.mark.parametrize("B,C,H,W,act,dt,out_dt,eps", CASES)
def test_emulated_kernel_matches_reference_and_pallas(
        B, C, H, W, act, dt, out_dt, eps, label, cap, min_bytes,
        max_cluster):
    x, s, b, xj, sj, bj = _inputs(B, C, H, W, dt)
    n, bg = C // 32 * H * W, B * 32
    p = (gn.plan(n, bg, x.element_size()) if cap is None else
         _small_plan(n, bg, x.element_size(), True, cap, min_bytes,
                     max_cluster))
    if label != "as planned":
        assert p.path == label or not p.vec, p
    got = emulate_k6(x, s, b, 32, eps, act, out_dt, p)
    ref = group_norm_silu_reference(xj, sj, bj, 32, eps, act, J_DT[out_dt])
    pal = group_norm_silu_pallas(xj, sj, bj, 32, eps, act, J_DT[out_dt],
                                 interpret=True)
    _assert_close(got, _nchw(ref), out_dt)
    _assert_close(got, _nchw(pal), out_dt)


@pytest.mark.parametrize("out_dt", [torch.bfloat16, torch.float32])
def test_limits_pass_reordered_statistics_and_reject_faults(out_dt):
    """A stand-in for K6 that differs from the plain version only in the
    order of its sums (statistics in f64, rounded to f32) stays within the
    limits; the planted faults do not."""
    gen = torch.Generator().manual_seed(3)
    x = activations(torch, (2, 128, 24, 20), torch.bfloat16, gen)
    s = 1 + 0.3 * torch.randn((128,), generator=gen)
    b = 0.2 * torch.randn((128,), generator=gen)
    args = (s, b, 32, 1e-5, True, out_dt)
    plain = gn.group_norm_silu_plain(x, *args)
    limit = groupnorm_limit(torch, x, s, b, 32, 1e-5, True, plain)

    xd = x.double().reshape(2, 32, -1)
    mean = xd.mean(-1, keepdim=True).float()
    var = ((xd * xd).mean(-1, keepdim=True).float() - mean * mean)
    y = ((x.float().reshape(2, 32, -1) - mean) * torch.rsqrt(var + 1e-5)
         ).reshape(x.shape) * s.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)
    reordered = (y * torch.sigmoid(y)).to(out_dt)
    assert groupnorm_ratio(torch, reordered, plain, limit) <= 1.0
    for fault in ("boundary", "no_silu", "chunk"):
        bad = planted_group_norm(torch, x, *args, fault)
        assert groupnorm_ratio(torch, bad, plain, limit) > 1.0, fault


def test_towers_hand_groupnorm_contiguous_inputs():
    """K6 takes contiguous NCHW x only and raises otherwise, which the CPU
    path does not enforce: every GroupNorm input of the UNet, ControlNet
    and VAE forwards must already be contiguous."""
    cfg = UNetConfig.tiny(in_channels=5)
    towers = {"unet": UNet2DCondition(cfg), "controlnet": ControlNet(cfg),
              "encoder": Encoder(VAEConfig.tiny()),
              "decoder": Decoder(VAEConfig.tiny())}
    seen = []

    def pre(mod, inp):
        seen.append(inp[0].is_contiguous())

    for m in towers.values():
        for g in m.modules():
            if isinstance(g, gn.GroupNormSiLU):
                g.register_forward_pre_hook(pre)
    ctx = torch.randn(2, 77, 32)
    with torch.no_grad():
        towers["unet"](torch.randn(2, 5, 16, 16), 10, ctx)
        towers["controlnet"](torch.randn(2, 5, 16, 16), 10, ctx,
                             torch.randn(2, 3, 128, 128))
        towers["encoder"](torch.randn(1, 3, 32, 32))
        towers["decoder"](torch.randn(1, 4, 8, 8))
    assert len(seen) > 50 and all(seen)


# -- the backward ---------------------------------------------------------------

# (B, C, H, W): groups of 30, 91 (ragged: not whole 16-byte vectors) and 100
# elements, 2, 3 and 4 channels a group
BWD_SHAPES = [(2, 64, 6, 5), (1, 96, 7, 13), (2, 128, 5, 5)]
NEEDS = [(True, True, True), (True, False, False)]


def _bwd_inputs(shape, dt, seed=0):
    gen = torch.Generator().manual_seed(seed + sum(shape))
    x = activations(torch, shape, dt, gen)
    C = shape[1]
    s = (1 + 0.3 * torch.randn((C,), generator=gen)).to(dt)
    b = (0.2 * torch.randn((C,), generator=gen)).to(dt)
    return x, s, b, output_gradient(torch, x, dt, gen)


def _assert_within(got, plain, limit):
    for a, p in zip(got, plain):
        assert (a is None) == (p is None)
        if a is not None:
            assert a.dtype == p.dtype and a.shape == p.shape
    assert groupnorm_bwd_ratio(torch, got, plain, limit) <= 1.0


@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_plain_matches_autograd(shape, act, dt, need):
    """The closed form against autograd through group_norm_silu_plain (x,
    scale and bias in dt, the output in dt), within chip_smoke's backward
    limit; None exactly where a gradient is not asked for."""
    x, s, b, g = _bwd_inputs(shape, dt)
    ins = [t.clone().requires_grad_(r) for t, r in zip((x, s, b), need)]
    y = gn.group_norm_silu_plain(*ins, 32, 1e-6, act, dt)
    got = torch.autograd.grad(y, [t for t, r in zip(ins, need) if r], g)
    it = iter(got)
    ref = [next(it) if r else None for r in need]
    plain = gn.group_norm_silu_bwd_plain(x, s, b, g, 32, 1e-6, act, need)
    _assert_within(ref, plain,
                   groupnorm_bwd_limit(torch, x, s, b, g, 32, 1e-6, act,
                                       plain))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_bwd_limits_pass_reordered_sums_and_reject_faults(dt):
    """A stand-in for gn_bwd that differs from the closed form only in the
    order of its sums (each taken in f64, rounded to f32) stays within the
    limits; the planted faults do not."""
    x, s, b, g = _bwd_inputs((2, 128, 24, 20), dt, seed=5)
    plain = gn.group_norm_silu_bwd_plain(x, s, b, g, 32, 1e-6, True)
    limit = groupnorm_bwd_limit(torch, x, s, b, g, 32, 1e-6, True, plain)

    dx, ds, db = (t.to(dt) for t in closed_form_bwd(
        torch, x, s, b, g, 32, 1e-6, True, torch.float32,
        sum_dtype=torch.float64)[:3])
    assert ds.shape == (128,)
    assert groupnorm_bwd_ratio(torch, (dx, ds, db), plain, limit) <= 1.0
    for fault in BWD_FAULTS:
        bad = planted_group_norm_bwd(torch, x, s, b, g, 32, 1e-6, True,
                                     fault)
        assert groupnorm_ratio(torch, bad, plain[0], limit[0]) > 1.0, fault


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_smoke_closed_form_is_the_plain_one(shape, act):
    """chip_smoke.closed_form_bwd, which the limits move and the planted
    faults break, is group_norm_silu_bwd_plain: in f64 on f64 inputs to
    f64's rounding, and in f32 within the backward limit."""
    x, s, b, g = _bwd_inputs(shape, torch.float32)
    wide = [t.double() for t in (x, s, b, g)]
    ref = gn.group_norm_silu_bwd_plain(*wide, 32, 1e-6, act)
    got = closed_form_bwd(torch, *wide, 32, 1e-6, act)[:3]
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == torch.float64
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    plain = gn.group_norm_silu_bwd_plain(x, s, b, g, 32, 1e-6, act)
    f32 = closed_form_bwd(torch, x, s, b, g, 32, 1e-6, act,
                          torch.float32)[:3]
    _assert_within(f32, plain, groupnorm_bwd_limit(
        torch, x, s, b, g, 32, 1e-6, act, plain))


@pytest.mark.parametrize("act", [True, False])
def test_smoke_library_bwd_is_the_same_gradient(act):
    """chip_smoke.library_bwd, the library's backward the smoke times
    beside gn_bwd, computes the same dx (f32, within the backward limit)."""
    x, s, b, g = _bwd_inputs((2, 128, 5, 5), torch.float32, seed=3)
    plain = gn.group_norm_silu_bwd_plain(x, s, b, g, 32, 1e-6, act)
    limit = groupnorm_bwd_limit(torch, x, s, b, g, 32, 1e-6, act, plain)
    got = library_bwd(torch, x, s, b, g, 32, 1e-6, act)()
    assert groupnorm_ratio(torch, got, plain[0], limit[0]) <= 1.0


@pytest.mark.parametrize("part,hw", [("slice encode", STEP_SLICE),
                                     ("canvas encode", STEP_CANVAS)])
def test_encoder_groupnorms_are_the_towers(monkeypatch, part, hw):
    """chip_smoke.vae_encoder_groupnorms, the shapes the card tests hold
    gn_bwd at, are the SDS step's encoder GroupNorm calls: 22, bf16."""
    sigs = _tower_signatures(monkeypatch, part)
    calls = vae_encoder_groupnorms(*hw)
    assert len(calls) == 22 == sum(sigs.values())
    want = {}
    for shape, _ in calls:
        want[(shape, torch.bfloat16)] = want.get((shape, torch.bfloat16),
                                                 0) + 1
    assert want == sigs
    assert sum(1 for _, act in calls if not act) == 1


def _check_bwd_plan(n, bg, sx, sg, max_cluster):
    p = gn.bwd_plan(n, bg, sx, sg, True, max_cluster)
    pack = 16 // min(sx, sg)
    assert p.vec == (n % pack == 0)
    assert 1 <= p.cluster <= max_cluster <= gn.MAX_CLUSTER
    # equal chunks, none empty, none missing
    assert (p.cluster - 1) * p.chunk < n <= p.cluster * p.chunk
    # x's and g's kept elements together within a CTA's shared memory
    assert 0 <= p.keep <= p.chunk and p.keep * (sx + sg) <= gn.SMEM_CAP
    if p.vec:
        assert p.chunk % pack == 0 and p.keep % pack == 0
        if n * (sx + sg) <= max_cluster * gn.SMEM_CAP:
            assert p.keep == p.chunk
    else:
        assert p.keep == 0
    assert p.path == ("cta" if p.cluster == 1 else "cluster") + (
        "+overflow" if p.keep < p.chunk else "")
    assert (bg * p.cluster >= gn.SMS or p.cluster == max_cluster
            or n * (sx + sg) < 2 * p.cluster * gn.MIN_CTA_BYTES)
    return p


ITEMSIZES = [(2, 2), (4, 4), (2, 4), (4, 2)]


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("hw", [(448, 448), (960, 640)])
def test_bwd_plan_covers_the_encoder_signatures(hw, max_cluster):
    """gn_bwd's plan at the 22 encoder GroupNorms of the slice and of the
    canvas, bf16 as the step runs them (every one whole 16-byte vectors)
    and in the other dtype pairs the kernel takes."""
    for shape, _ in vae_encoder_groupnorms(*hw):
        n = math.prod(shape) // 32
        for sx, sg in ITEMSIZES:
            p = _check_bwd_plan(n, 32, sx, sg, max_cluster)
            assert p.vec, shape


@pytest.mark.parametrize("n,bg", [(3 * 91, 32), (7, 64), (1, 32),
                                  (2 ** 20 + 6, 32), (40961, 2)])
def test_bwd_plan_covers_ragged_groups(n, bg):
    for sx, sg in ITEMSIZES:
        for max_cluster in (16, 8, 4):
            _check_bwd_plan(n, bg, sx, sg, max_cluster)


def test_bwd_plans_of_the_largest_groups():
    """The canvas's 2.46 M-element groups and the slice's 0.8 M-element ones
    in clusters of 16 with an overflow (a rank keeps 28,672 elements of x and
    of g: 112 KB), the mid blocks' on chip in 8 (canvas) and 4 (slice)."""
    for n, chunk in ((4 * 960 * 640, 153600), (4 * 448 * 448, 50176)):
        assert gn.bwd_plan(n, 32, 2, 2) == gn.Plan(
            "cluster+overflow", 16, chunk, 28672, True)
    assert gn.bwd_plan(16 * 120 * 80, 32, 2, 2) == gn.Plan(
        "cluster", 8, 19200, 19200, True)
    assert gn.bwd_plan(16 * 56 * 56, 32, 2, 2).path == "cluster"
    assert gn.bwd_plan(240, 64, 4, 4) == gn.Plan("cta", 1, 240, 240, True)
    assert gn.bwd_plan(3 * 91, 32, 4, 2).path == "cta+overflow"


def emulate_gn_bwd(x, scale, bias, g, groups, eps, act, need, p):
    """csrc/groupnorm.cu gn_bwd's partition in torch for plan p: rank r of a
    group's cluster owns units [r chunk, (r + 1) chunk) of the group,
    clipped to it (units of 16 / min(element sizes) elements with vec, else
    one); each rank's (sum x, sum x^2), then (sum dxhat, sum dxhat xhat),
    over its elements in f32, the ranks' added in rank order; dx element by
    element; and for dscale / dbias each rank's sums of g' xhat and g' over
    the part of each channel of its group that its share holds (zero for
    the others), laid out (B G cs, C/G, 2) and added over the batch and the
    ranks as the wrapper adds them."""
    B, C = x.shape[:2]
    cpg = C // groups
    xf = x.float().reshape(B * groups, -1)
    gf = g.float().reshape(B * groups, -1)
    n = xf.shape[1]
    hw = n // cpg
    unit = 16 // min(x.element_size(), g.element_size()) if p.vec else 1
    nu, cu = n // unit, p.chunk // unit
    spans = []
    for r in range(p.cluster):
        lo = min(r * cu, nu)
        spans.append((lo * unit, min(lo + cu, nu) * unit))
    assert spans[-1][1] == n and all(a < b for a, b in spans)

    def in_rank_order(*terms):
        tot = torch.zeros(B * groups, len(terms))
        for e0, e1 in spans:
            tot = tot + torch.stack([t[:, e0:e1].sum(1) for t in terms], 1)
        return [tot[:, i:i + 1] / n for i in range(len(terms))]

    mean, e2 = in_rank_order(xf, xf * xf)
    rstd = torch.rsqrt(e2 - mean * mean + eps)
    cidx = (torch.arange(B * groups) % groups)[:, None] * cpg + (
        torch.arange(n) // hw)[None, :]
    sc, bi = scale.float()[cidx], bias.float()[cidx]
    xh = (xf - mean) * rstd
    gp = gf
    if act:
        y = xh * sc + bi
        sig = 1.0 / (1.0 + torch.exp(-y))
        gp = gf * sig * (1 + y * (1 - sig))
    d = gp * sc
    m1, m2 = in_rank_order(d, d * xh)
    dx = (rstd * (d - m1 - xh * m2)).reshape(x.shape).to(x.dtype)
    part = torch.zeros(B * groups, p.cluster, cpg, 2)
    for r, (e0, e1) in enumerate(spans):
        for c in range(cpg):
            b0, b1 = max(e0, c * hw), min(e1, (c + 1) * hw)
            part[:, r, c, 0] = (gp * xh)[:, b0:b1].sum(1)
            part[:, r, c, 1] = gp[:, b0:b1].sum(1)
    sums = part.view(B, groups, p.cluster, cpg, 2).sum((0, 2)).view(C, 2)
    return (dx if need[0] else None,
            sums[:, 0].to(scale.dtype) if need[1] else None,
            sums[:, 1].to(bias.dtype) if need[2] else None)


# (plan label, SMEM_CAP, MIN_CTA_BYTES, max cluster)
EMULATED_BWD_PLANS = [("as planned", None, None, 16),
                      ("cluster", 1 << 20, 64, 4),
                      ("cluster+overflow", 64, 32, 3),
                      ("cta+overflow", 192, 1 << 20, 1)]


@pytest.mark.parametrize("label,cap,min_bytes,max_cluster",
                         EMULATED_BWD_PLANS)
@pytest.mark.parametrize("shape,act,dt", [
    ((2, 64, 6, 5), True, torch.float32),
    ((1, 96, 7, 13), False, torch.float32),
    ((2, 128, 5, 5), True, torch.bfloat16)])
def test_emulated_bwd_matches_plain(shape, act, dt, label, cap, min_bytes,
                                    max_cluster):
    x, s, b, g = _bwd_inputs(shape, dt, seed=9)
    n, bg = math.prod(shape[1:]) // 32, shape[0] * 32
    sx = sg = x.element_size()
    p = (gn.bwd_plan(n, bg, sx, sg) if cap is None else
         _small_plan(n, bg, sx, True, cap, min_bytes, max_cluster, sg))
    if label != "as planned":
        assert p.path == label or not p.vec, p
    need = (True, True, True)
    got = emulate_gn_bwd(x, s, b, g, 32, 1e-6, act, need, p)
    plain = gn.group_norm_silu_bwd_plain(x, s, b, g, 32, 1e-6, act, need)
    _assert_within(got, plain, groupnorm_bwd_limit(
        torch, x, s, b, g, 32, 1e-6, act, plain))
