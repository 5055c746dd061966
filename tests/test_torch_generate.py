"""The port's Zero123++ generation (contexture_nerf_tpu_torch/diffusion/
schedulers.py `DDPM`, `EulerAncestral`; zero123plus.py
`Zero123PlusPipeline.generate`; check_gt_zero123plus.py) against the JAX
reference at tiny size, f32, on the CPU.

One JAX pipeline (its UNet, ControlNet and VAE perturbed off the init,
carried across by weights.py) with the tiny SD2 stack's inpaint UNet
attached (perturbed too) is built per module; `generate` is compiled for
three signatures: plain (2 steps), blending (3 steps) and inpaint with
blending (12 steps, so 10 < i < 20 fires). The port is fed the reference's `jax.random` draws, rebuilt from
its key exactly as it splits it.

Tolerances: the timesteps are exact and the sigmas agree to 2.6e-6
relative (the two f32 cumprods of alphas_cumprod differ by 1.4e-6); a
sampler step
on given outputs and draws agrees to 1e-6 of its scale. `generate` starts
from sigma_0 ~ 14.6 times the latent draw and runs each step's difference
through CFG at 4, then the decoder multiplies the latent by 1 / (0.75 *
0.18215) ~ 7.3; the grids agree to 1.1e-4 / 1.3e-4 / 1.2e-4 (plain /
blending / inpaint, measured) on [0, 1], held to 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.diffusion import schedulers as jsch
from contexture_nerf_tpu.diffusion.sd_depth import \
    StableDiffusionDepth as JSD
from contexture_nerf_tpu.diffusion.zero123plus import \
    Zero123PlusPipeline as JPipeline
from contexture_nerf_tpu_torch import check_gt_zero123plus, weights
from contexture_nerf_tpu_torch.diffusion import schedulers as tsch
from contexture_nerf_tpu_torch.diffusion.sd_depth import StableDiffusionDepth
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    GENERATION_STEP_DRAWS, Zero123PlusPipeline, Zero123PlusTeacher)
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.ops.image import save_image, tensor2numpy
from contexture_nerf_tpu_torch.tools.launches import census

H, W = 48, 32  # a 3x2 canvas of 16 px tiles; the tiny VAE halves it
LAT = (1, 4, H // 2, W // 2)
COND = (1, 4, 16, 16)  # the 32^2 condition image's latent
KEY = 7
GRID_TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed=0):
    """Every leaf moved off its init (norm scales off 1, biases off 0)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(int(np.prod(x.shape[:-1])))
    return jax.tree.map(move, tree)


def _close(got, ref, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


# -- the samplers ------------------------------------------------------------

@pytest.mark.parametrize("spacing", ["trailing", "linspace"])
def test_euler_timesteps_exact_and_sigmas(spacing):
    """Every n in 1..50: the integers exactly (the trailing arange is f32
    in the reference, which moves some values across a .5, at n = 48),
    the sigmas to f32 rounding."""
    ref = jsch.EulerAncestral.create(timestep_spacing=spacing)
    port = tsch.EulerAncestral.create(timestep_spacing=spacing,
                                      device="cpu")
    for n in range(1, 51):
        r_ts, r_sig = ref.timesteps_and_sigmas(n)
        ts, sig = port.timesteps_and_sigmas(n)
        assert ts == np.asarray(r_ts).tolist(), n
        assert sig.dtype == torch.float32 and sig.shape == (n + 1,)
        # the f32 cumprods of the two alphas_cumprod differ by up to
        # 1.4e-6 relative; the sigmas by 2.6e-6 (measured)
        np.testing.assert_allclose(sig.numpy(), np.asarray(r_sig),
                                   rtol=5e-6, atol=0)


def test_trailing_rounds_before_subtracting():
    """diffusers' order: round(arange) - 1, half to even; the other order
    differs by 1 in 8 of the 16 entries at n = 16."""
    ts = tsch.trailing_timesteps(1000, 16)
    other = (np.round(np.arange(1000, 0, -1000 / 16) - 1)).astype(int)
    assert sum(a != b for a, b in zip(ts, other)) == 8
    assert ts[0] == 999 and len(ts) == 16


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("t", [0, 20, 500, 999])
def test_ddpm_step(prediction, t):
    """One ancestral step on a given output and draw, t = 0 without
    noise (the t > 0 gate) and t > 0 with it."""
    ref = jsch.DDPM.create(prediction_type=prediction)
    port = tsch.DDPM.create(prediction_type=prediction, device="cpu")
    assert port.timesteps(28) == np.asarray(ref.timesteps(28)).tolist()
    rng = np.random.default_rng(t)
    x, out = (rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
              for _ in range(2))
    key = jax.random.PRNGKey(t)
    noise = np.asarray(jax.random.normal(key, x.shape))
    r = ref.step(jnp.asarray(out), t, jnp.asarray(x), key, 50)
    got = port.step(torch.from_numpy(out), t, torch.from_numpy(x),
                    torch.from_numpy(noise), 50)
    _close(got, r, 1e-6)
    if t == 0:  # no noise at t = 0: the draw does not matter
        again = port.step(torch.from_numpy(out), t, torch.from_numpy(x),
                          torch.randn(x.shape), 50)
        assert torch.equal(got, again)


def test_v_prediction_conversions():
    ref_acp = jsch.make_alphas_cumprod()
    acp = tsch.make_alphas_cumprod(device="cpu")
    rng = np.random.default_rng(3)
    x, v = (rng.standard_normal((2, 4, 5, 5)).astype(np.float32)
            for _ in range(2))
    t = np.array([17, 801])
    for tf, jf in ((tsch.pred_x0_from_v, jsch.pred_x0_from_v),
                   (tsch.pred_eps_from_v, jsch.pred_eps_from_v)):
        _close(tf(acp, torch.from_numpy(x), torch.from_numpy(v),
                  torch.from_numpy(t)),
               jf(ref_acp, jnp.asarray(x), jnp.asarray(v), jnp.asarray(t)),
               1e-6)


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon"])
def test_euler_ancestral_step(prediction):
    ref = jsch.EulerAncestral.create(prediction_type=prediction)
    port = tsch.EulerAncestral.create(prediction_type=prediction,
                                      device="cpu")
    r_ts, r_sig = ref.timesteps_and_sigmas(28)
    _, sig = port.timesteps_and_sigmas(28)
    rng = np.random.default_rng(1)
    x, out = (rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
              for _ in range(2))
    x *= float(r_sig[0])
    for i in (0, 5, 27):  # the first, a middle and the last (sigma_to 0)
        key = jax.random.PRNGKey(i)
        noise = np.asarray(jax.random.normal(key, x.shape))
        r = ref.step(jnp.asarray(out), i, jnp.asarray(x), r_sig, key)
        got = port.step(torch.from_numpy(out), i, torch.from_numpy(x), sig,
                        torch.from_numpy(noise))
        _close(got, r, 1e-6)
    sigma = sig[3]
    _close(port.scale_model_input(torch.from_numpy(x), sigma),
           ref.scale_model_input(jnp.asarray(x), r_sig[3]), 1e-6)
    _close(port.add_noise(torch.from_numpy(x), torch.from_numpy(out), sigma),
           ref.add_noise(jnp.asarray(x), jnp.asarray(out), r_sig[3]), 1e-6)


# -- generate ----------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    ref = JPipeline(tiny=True, seed=0)
    ref.params = {k: (jax.tree.map(jnp.asarray, _perturbed(v, i))
                      if k in ("unet", "controlnet", "vae") else v)
                  for i, (k, v) in enumerate(ref.params.items())}
    sd_ref = JSD(tiny=True, seed=0)
    ref.attach_inpaint_unet(sd_ref.inpaint_unet, jax.tree.map(
        jnp.asarray, _perturbed(sd_ref.params["inpaint_unet"], 9)))
    port = Zero123PlusPipeline(tiny=True, device="cpu")
    weights.load_teacher(port, jax.tree.map(np.asarray, ref.params))
    sd = StableDiffusionDepth(tiny=True, device="cpu")
    sd.inpaint_unet.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, ref.inpaint_params)))
    port.attach_inpaint_unet(sd.inpaint_unet)
    return ref, port


def _jax_draws(key, n):
    """generate's draws as the reference makes them from `key`: k_cond,
    k_loop; k1, k2 (the conditioning); kl (the latent); each step kw, ks_,
    kb, then k_neg, k_cond of kw inside _cfg_core."""
    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    k_cond, k_loop = jax.random.split(key)
    k1, k2 = jax.random.split(k_cond)
    d = {"eps_cond": normal(k1, COND), "eps_neg": normal(k2, COND)}
    kl, key = jax.random.split(k_loop)
    d["latents"] = normal(kl, LAT)
    steps = []
    for _ in range(n):
        kw, ks_, kb, key = jax.random.split(key, 4)
        k_neg, k_c = jax.random.split(kw)
        steps.append((normal(k_neg, COND[1:]), normal(k_c, COND[1:]),
                      normal(ks_, LAT), normal(kb, LAT)))
    for j, name in enumerate(GENERATION_STEP_DRAWS):
        d[name] = torch.stack([s[j] for s in steps])
    return d


def _inputs():
    rng = np.random.default_rng(0)
    cond = rng.random((1, 3, 32, 32)).astype(np.float32) * 2 - 1
    depth = rng.random((1, 3, H, W)).astype(np.float32)
    mask = np.zeros((1, 1) + LAT[2:], np.float32)
    mask[..., 4:18, 3:12] = 1  # neither all 0 nor all 1
    renders, masked = (0.5 * rng.standard_normal(LAT).astype(np.float32)
                       for _ in range(2))
    return cond, depth, mask, renders, masked


# (steps, use_blending, use_inpaint)
GENERATE = {"plain": (2, False, False), "blending": (3, True, False),
            "inpaint_blending": (12, True, True)}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_reference(pipes, case):
    ref, port = pipes
    n, blend, inpaint = GENERATE[case]
    cond, depth, mask, renders, masked = _inputs()
    extra = {}
    if blend or inpaint:
        extra["latent_mask_grid"] = mask
        extra["latent_renders_grid"] = renders
    if inpaint:
        extra["masked_input_latents"] = masked
    key = jax.random.PRNGKey(KEY)
    r = ref.generate(jnp.asarray(cond), jnp.asarray(depth),
                     num_inference_steps=n, guidance_scale=4.0, key=key,
                     height=H, width=W, use_blending=blend,
                     use_inpaint=inpaint,
                     **{k: jnp.asarray(v) for k, v in extra.items()})
    got = port.generate(torch.from_numpy(cond), torch.from_numpy(depth),
                        num_inference_steps=n, guidance_scale=4.0, height=H,
                        width=W, use_blending=blend, use_inpaint=inpaint,
                        draws=_jax_draws(key, n),
                        **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.shape == (1, 3, H, W) and got.dtype == torch.float32
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    _close(got, r, GRID_TOL)


def test_mask_ones_reproduces_the_plain_loop(pipes):
    """mask == 1: every blend is lat * 1 + x * 0, so the blended loop is
    the plain one bit for bit (the draws are the same whatever the
    flags)."""
    _, port = pipes
    cond, depth, _, renders, _ = _inputs()
    args = (torch.from_numpy(cond), torch.from_numpy(depth))
    kw = dict(num_inference_steps=3, guidance_scale=2.0, height=H, width=W)
    plain = port.generate(*args, generator=torch.Generator().manual_seed(3),
                          **kw)
    blended = port.generate(
        *args, generator=torch.Generator().manual_seed(3), use_blending=True,
        latent_mask_grid=torch.ones((1, 1) + LAT[2:]),
        latent_renders_grid=torch.from_numpy(renders), **kw)
    assert torch.equal(plain, blended)


def test_mask_zeros_gives_the_decode_of_the_renders(pipes):
    """mask == 0: the final blend replaces the latent by the clean renders,
    so the output is their decode."""
    _, port = pipes
    cond, depth, _, renders, _ = _inputs()
    out = port.generate(
        torch.from_numpy(cond), torch.from_numpy(depth),
        num_inference_steps=3, guidance_scale=2.0, height=H, width=W,
        use_blending=True, latent_mask_grid=torch.zeros((1, 1) + LAT[2:]),
        latent_renders_grid=torch.from_numpy(renders))
    assert torch.equal(out, port.decode_grid(torch.from_numpy(renders)))


def test_generate_raises_where_the_reference_raises(pipes):
    _, port = pipes
    cond, depth, mask, renders, masked = _inputs()
    args = (torch.from_numpy(cond), torch.from_numpy(depth))
    kw = dict(num_inference_steps=2, height=H, width=W)
    m, r, ml = (torch.from_numpy(x) for x in (mask, renders, masked))
    bare = Zero123PlusPipeline(tiny=True, device="cpu")
    for pipe, extra, match in (
            (bare, dict(use_inpaint=True, latent_mask_grid=m,
                        masked_input_latents=ml), "attach_inpaint_unet"),
            (port, dict(use_blending=True, latent_renders_grid=r),
             "latent_mask_grid"),
            (port, dict(use_inpaint=True, masked_input_latents=ml),
             "latent_mask_grid"),
            (port, dict(use_blending=True, latent_mask_grid=m),
             "latent_renders_grid"),
            (port, dict(use_inpaint=True, latent_mask_grid=m),
             "masked_input_latents")):
        with pytest.raises(ValueError, match=match):
            pipe.generate(*args, **kw, **extra)


def test_pipeline_keeps_the_teachers_towers():
    """The pipeline's towers are the teacher's from the same seed (its
    decoder draws after them), so building it leaves the SDS teacher and
    every later draw of its generator as they were."""
    teacher = Zero123PlusTeacher(tiny=True, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    pipe = Zero123PlusPipeline(tiny=True, device="cpu",
                               generator=torch.Generator().manual_seed(4))
    ts = teacher.state_dict()
    ps = pipe.state_dict()
    assert set(ps) - set(ts) == {k for k in ps if k.startswith(
        "vae_decoder.")}
    assert all(torch.equal(ts[k], ps[k]) for k in ts)
    assert pipe.inpaint_unet is None
    assert not any(k.startswith("inpaint") for k in ps)


def test_generate_groupnorms_equal_the_derived_launches(pipes):
    """The census of generate with inpaint: one K6 launch for each
    GroupNorm call of the pipeline's towers (the conditioning's encodes,
    the teacher's steps, the inpaint steps, the decode) and no gn_bwd, since
    nothing is differentiated; the tiny lengths route no attention call to
    the kernel."""
    _, port = pipes
    cond, depth, mask, renders, masked = _inputs()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, inp: seen.append(1))
             for tower in (port, port.inpaint_unet) for m in tower.modules()
             if isinstance(m, GroupNormSiLU)]
    try:
        with census() as c:
            port.generate(torch.from_numpy(cond), torch.from_numpy(depth),
                          num_inference_steps=12, height=H, width=W,
                          use_blending=True, use_inpaint=True,
                          latent_mask_grid=torch.from_numpy(mask),
                          latent_renders_grid=torch.from_numpy(renders),
                          masked_input_latents=torch.from_numpy(masked))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) > 0
    assert c.counts == {"flash_attn_single": 0, "flash_attn_two_source": 0,
                        "groupnorm": len(seen), "groupnorm_bwd": 0}


def test_check_gt_zero123plus_writes_the_grid_and_six_views(tmp_path):
    rng = np.random.default_rng(5)
    save_image(tensor2numpy(rng.random((40, 40, 3))), tmp_path / "cond.png")
    save_image(tensor2numpy(rng.random((90, 60, 3))), tmp_path / "depth.png")
    out = tmp_path / "gt"
    pipe, grid = check_gt_zero123plus.main(
        ["--cond", str(tmp_path / "cond.png"), "--depth_grid",
         str(tmp_path / "depth.png"), "--out_dir", str(out), "--steps", "2",
         "--tiny"], device="cpu")
    names = sorted(p.name for p in out.iterdir())
    assert names == ["grid.png"] + [f"view_{i}.png" for i in range(6)]
    assert grid.shape == (1, 3, 3 * pipe.tile_px, 2 * pipe.tile_px)
    assert bool(torch.isfinite(grid).all())
    from PIL import Image

    assert Image.open(out / "grid.png").size == (64, 96)
    assert Image.open(out / "view_5.png").size == (32, 32)
