"""The port's GroupNorm(+SiLU) (contexture_nerf_tpu_torch/ops/groupnorm.py)
against the JAX reference on the CPU: the plain version against
`group_norm_silu_reference` and the Pallas kernel in interpret mode (both
channels-last, so the inputs are transposed), and the gradients against
`jax.grad` of the reference's custom-VJP `group_norm_silu`. Then what the
CPU can check of the kernel's dispatch and limits: a CPU tensor takes the
plain version and launches nothing, K6's chunking covers every group, and
the limits chip_smoke.py holds K6 to pass a plain run whose statistics were
summed in another order but reject the three planted faults.

Tolerances: f32 output within 2e-6 of max(1, |ref|) (the two sum the
statistics in other orders); bf16 output within one bf16 ulp of the
reference's magnitude (plus 1e-6), since f32 values that differ in the
last bits can round to neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (activations, groupnorm_limit, groupnorm_ratio,
                        planted_group_norm)
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


@pytest.mark.parametrize("n,bg,itemsize", [
    (10 * 4096, 64, 2), (4 * 262144, 32, 2), (40 * 64, 64, 2),
    (3 * 91, 32, 4), (1, 65535, 4), (30 * 120 * 80, 64, 2)])
def test_kernel_split_covers_every_group(n, bg, itemsize):
    s, chunk, vec = gn.kernel_split(n, bg, itemsize)
    pack = 16 // itemsize
    assert vec == (n % pack == 0)
    assert (s - 1) * chunk < n <= s * chunk  # no empty chunk, none missing
    if vec:
        assert chunk % pack == 0
    # enough CTAs for the card, unless each already holds one load a thread
    assert bg * s >= gn.TARGET_CTAS or chunk <= gn.THREADS * pack + pack


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
