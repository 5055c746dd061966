"""The port's SD2-depth stack (contexture_nerf_tpu_torch/diffusion/sd_depth.py
and its parts) against the JAX reference at tiny size, f32, on the CPU: the
PNDM timesteps and a PLMS trajectory on given model outputs, the 5- and
9-channel UNets, the VAE decoder, the bicubic and nearest resizes, the text
embedding pair, and `img2img_step` fed the reference's four `jax.random`
draws: the update-mask path, noised_gt_init (no update mask), latent
blending, the inpaint UNet at 10 < i < 20, and the intermediate images.

Weights: the reference's seeded init, every leaf perturbed off it (norm
scales off 1, biases off 0), carried across by weights.py.

Tolerances: f32 throughout; XLA and torch sum convolutions and matmuls in
other orders, so single towers agree to ~1e-5 of their output's scale; the
PLMS closed form agrees to f32 rounding; img2img runs each difference
through the CFG at 7.5 and several scheduler steps, then the decoder, and
agrees to ~1e-4 on [0, 1] images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.diffusion import schedulers as jsch
from contexture_nerf_tpu.diffusion.sd_depth import \
    StableDiffusionDepth as JSD
from contexture_nerf_tpu.diffusion.unet import UNetConfig as JUNetConfig
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.diffusion import schedulers as tsch
from contexture_nerf_tpu_torch.diffusion.sd_depth import (DRAWS,
                                                          StableDiffusionDepth)
from contexture_nerf_tpu_torch.diffusion.unet import UNetConfig
from contexture_nerf_tpu_torch.diffusion.vae import decode
from contexture_nerf_tpu_torch.ops.image import resize_bicubic, resize_nearest

PROMPT = "a photo of a dairy cow"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed=0):
    """Every leaf moved off its init, as numpy f32."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(fan_in)
    return jax.tree.map(move, tree)


def _close(got, ref, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


# -- PNDM ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [50, 4, 12])
def test_pndm_timesteps(n):
    ref = jsch.PNDM.create().timesteps(n)
    got = tsch.PNDM.create(device="cpu").timesteps(n)
    assert got == np.asarray(ref).tolist() and len(got) == n + 1


def test_plms_trajectory_on_given_outputs():
    """51 PLMS steps of the 50-step sequence, each fed the same model
    output on both sides: the counter == 1 re-run and the 1, 1, 2, 3, 4
    order ramp included."""
    j, t = jsch.PNDM.create(), tsch.PNDM.create(device="cpu")
    rng = np.random.default_rng(0)
    shape = (1, 4, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    js, ts_ = j.init_state(shape), t.init_state(shape, "cpu")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for step in j.timesteps(50).tolist():
        eps = rng.standard_normal(shape).astype(np.float32)
        js, jx = j.step(js, jnp.asarray(eps), step, jx, 50)
        ts_, tx = t.step(ts_, torch.from_numpy(eps), step, tx, 50)
        _close(tx, jx, 2e-6)
    assert ts_.counter == int(js.counter) == 51


def test_full_size_unet_configs():
    for port, ref in ((UNetConfig.sd2_depth(), JUNetConfig.sd2_depth()),
                      (UNetConfig.sd2_inpaint(), JUNetConfig.sd2_inpaint())):
        for k in ("in_channels", "out_channels", "block_out_channels",
                  "layers_per_block", "cross_attention_dim", "num_heads",
                  "transformer_depth"):
            assert getattr(port, k) == getattr(ref, k), k


# -- resizes ------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bicubic", "nearest"])
@pytest.mark.parametrize("src,dst", [((700, 650), (64, 64)),
                                     ((37, 41), (8, 8)),
                                     ((8, 8), (64, 64)),
                                     ((20, 17), (33, 40))])
def test_resizes_match_jax_image_resize(method, src, dst):
    x = np.random.default_rng(sum(src)).standard_normal(
        (1, 1) + src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 1) + dst, method=method)
    fn = resize_bicubic if method == "bicubic" else resize_nearest
    _close(fn(torch.from_numpy(x), dst), ref, 2e-6)


# -- the stack -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks():
    ref = JSD(tiny=True, seed=0)
    ref.params = jax.tree.map(jnp.asarray, _perturbed(ref.params, 5))
    port = StableDiffusionDepth(tiny=True, device="cpu")
    weights.load_sd_depth(port, jax.tree.map(np.asarray, ref.params))
    return ref, port


@pytest.mark.parametrize("tower", ["unet", "inpaint_unet"])
def test_sd2_unets(stacks, tower):
    """The 5-channel depth UNet and the 9-channel inpaint UNet."""
    ref, port = stacks
    in_ch = 5 if tower == "unet" else 9
    rng = np.random.default_rng(in_ch)
    x = rng.standard_normal((2, in_ch, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([961, 961])
    jm = getattr(ref, tower)
    out = jax.jit(jm.apply)(ref.params[tower], jnp.asarray(x),
                            jnp.asarray(t), jnp.asarray(ctx))
    m = getattr(port, tower)
    assert m.conv_in.weight.shape[1] == in_ch
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx))
    _close(got, out, 2e-5)


def test_vae_decoder(stacks):
    ref, port = stacks
    z = np.random.default_rng(1).standard_normal((1, 4, 12, 10)).astype(
        np.float32)
    out = jax.jit(lambda p, z: ref.vae.apply(p, z, method=ref.vae.decode))(
        ref.params["vae"], jnp.asarray(z))
    with torch.no_grad():
        got = decode(port.vae_decoder, torch.from_numpy(z))
    assert got.shape == (1, 3, 24, 20)
    _close(got, out, 2e-5)
    _close(port.decode_latents(torch.from_numpy(z)),
           ref.decode_latents(jnp.asarray(z)), 2e-5)


def test_text_embeds(stacks):
    ref, port = stacks
    got = port.get_text_embeds([PROMPT])
    assert got.shape == (2, 77, 32)
    _close(got, ref.get_text_embeds([PROMPT]), 1e-5)
    _close(port.get_text_embeds(PROMPT, ["blurry"]),
           ref.get_text_embeds([PROMPT], ["blurry"]), 1e-5)


def _jax_draws(seed, shape):
    """The draws of the reference's img2img `run` from PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {k: torch.from_numpy(np.array(jax.random.normal(kk, shape)))
            for k, kk in zip(DRAWS, keys)}


def _crops(seed=0):
    """A 40x36 crop: rgb in [0,1], a depth ramp with noise, and an object
    mask (an ellipse)."""
    rng = np.random.default_rng(seed)
    h, w = 40, 36
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - 20) / 16.0) ** 2 + ((xx - 18) / 14.0) ** 2 <= 1)
    rgb = rng.random((1, 3, h, w)).astype(np.float32)
    depth = (mask * (0.3 + 0.5 * yy / h + 0.05 * rng.random((h, w)))
             ).astype(np.float32)[None, None]
    return rgb, depth, mask.astype(np.float32)[None, None]


# (steps, update mask, blending, inpaint, intermediate_vis); the inpaint
# UNet runs at 10 < i < 20, so its case takes 12 steps (13 timesteps)
IMG2IMG = {
    "update_mask_blending_vis": (4, True, True, False, True),
    "noised_gt_init": (4, False, False, False, False),
    "update_mask_inpaint": (12, True, False, True, False),
}


@pytest.mark.parametrize("case", list(IMG2IMG))
def test_img2img_step(stacks, case):
    ref, port = stacks
    steps, with_mask, blend, inpaint, vis = IMG2IMG[case]
    rgb, depth, mask = _crops()
    text = ref.get_text_embeds([PROMPT])
    ref.use_inpaint = inpaint
    try:
        r_img, r_inter = ref.img2img_step(
            text, jnp.asarray(rgb), jnp.asarray(depth), guidance_scale=7.5,
            num_inference_steps=steps,
            update_mask=jnp.asarray(mask) if with_mask else None,
            fixed_seed=3, intermediate_vis=vis, use_latent_blending=blend)
    finally:
        ref.use_inpaint = True
    draws = _jax_draws(3, port.latent_shape())
    t = torch
    img, inter = port.img2img_step(
        t.from_numpy(np.array(text)), t.from_numpy(rgb),
        t.from_numpy(depth), guidance_scale=7.5, num_inference_steps=steps,
        update_mask=t.from_numpy(mask) if with_mask else None, fixed_seed=3,
        intermediate_vis=vis, use_latent_blending=blend, use_inpaint=inpaint,
        draws=draws)
    assert img.shape == (1, 3, 64, 64)
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    _close(img, r_img, 2e-4)
    assert len(inter) == len(r_inter) == (steps + 1 if vis else 0)
    for a, b in zip(inter, r_inter):
        _close(a, b, 2e-4)
