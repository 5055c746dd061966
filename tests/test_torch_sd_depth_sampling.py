"""The rest of the port's SD2-depth stack (contexture_nerf_tpu_torch/
diffusion/sd_depth.py `img2img_single_step`, `produce_latents`,
`prompt_to_img`, `sds_grad`, and the `min_timestep` / `max_timestep` /
`no_noise` knobs `build_models` passes) against the JAX reference at tiny
size, f32, on the CPU, fed the reference's `jax.random` draws.

Weights: the reference's seeded init, every leaf perturbed off it,
carried across by weights.py (as tests/test_torch_sd_depth.py does).

Tolerances: f32; XLA and torch sum convolutions and matmuls in other
orders. One UNet step agrees to ~1e-6 of its scale, three PLMS steps
under CFG to ~1e-5, the SDS gradient at CFG 100 to ~1e-5 (measured 6e-6
and 7e-6), held to 1e-5 and 2e-5 of scale; `prompt_to_img`'s uint8
images within one level.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.diffusion.sd_depth import \
    StableDiffusionDepth as JSD
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.diffusion.sd_depth import StableDiffusionDepth
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.training.trainer import build_models

PROMPT = "a photo of a dairy cow"
LAT = (1, 4, 16, 16)
TORUS = Path(__file__).resolve().parents[1] / "shapes" / "torus.obj"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed=0):
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(int(np.prod(x.shape[:-1])))
    return jax.tree.map(move, tree)


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


@pytest.fixture(scope="module")
def stacks():
    ref = JSD(tiny=True, seed=0, min_timestep=0.1, max_timestep=0.5)
    ref.params = jax.tree.map(jnp.asarray, _perturbed(ref.params, 5))
    port = StableDiffusionDepth(tiny=True, device="cpu", min_timestep=0.1,
                                max_timestep=0.5)
    weights.load_sd_depth(port, jax.tree.map(np.asarray, ref.params))
    text = ref.get_text_embeds([PROMPT])
    return ref, port, text, torch.from_numpy(np.array(text))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal(LAT).astype(np.float32)
    depth_crop = rng.random((1, 1, 40, 36)).astype(np.float32)
    depth_lat = (rng.random((1, 1) + LAT[2:]) * 2 - 1).astype(np.float32)
    return lat, depth_crop, depth_lat


@pytest.mark.parametrize("step", [981, 501, 21])
def test_img2img_single_step(stacks, step):
    ref, port, text, t_text = stacks
    lat, depth, _ = _inputs(step)
    r = ref.img2img_single_step(text, jnp.asarray(lat), jnp.asarray(depth),
                                step, guidance_scale=7.5)
    got = port.img2img_single_step(t_text, torch.from_numpy(lat),
                                   torch.from_numpy(depth), step,
                                   guidance_scale=7.5)
    _close(got, r, 1e-5)


def test_produce_latents(stacks):
    """Three PLMS steps (the 1, 1, 2 order ramp and the counter == 1
    re-run) from the reference's latent draw."""
    ref, port, text, t_text = stacks
    _, _, depth = _inputs(1)
    key = jax.random.PRNGKey(4)
    r = ref.produce_latents(text, jnp.asarray(depth), key, height=32,
                            width=32, num_inference_steps=3)
    got = port.produce_latents(t_text, torch.from_numpy(depth),
                               latents=_normal(key, LAT), height=32,
                               width=32, num_inference_steps=3)
    _close(got, r, 2e-5)
    # without latents: a draw from the generator, the same for one seed
    a = port.produce_latents(t_text, torch.from_numpy(depth), height=32,
                             width=32, num_inference_steps=1,
                             generator=torch.Generator().manual_seed(2))
    b = port.produce_latents(t_text, torch.from_numpy(depth), height=32,
                             width=32, num_inference_steps=1,
                             generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and a.shape == LAT


@pytest.mark.parametrize("no_noise", [False, True])
def test_sds_grad(stacks, no_noise):
    """At the reference's t and noise (its key split into k_t, k_n); with
    no_noise the noise is zero whatever is passed."""
    ref, port, text, t_text = stacks
    lat, _, depth = _inputs(2)
    key = jax.random.PRNGKey(9)
    k_t, k_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(k_t, (1,), ref.min_step,
                                      ref.max_step + 1))
    ref.no_noise = port.no_noise = no_noise
    try:
        r = ref.sds_grad(jnp.asarray(lat), text, jnp.asarray(depth), key)
        got = port.sds_grad(torch.from_numpy(lat), t_text,
                            torch.from_numpy(depth), t=torch.from_numpy(t),
                            noise=_normal(k_n, LAT))
    finally:
        ref.no_noise = port.no_noise = False
    assert got.dtype == torch.float32
    _close(got, r, 2e-5)


def test_sds_grad_draws_t_in_its_range(stacks):
    _, port, _, t_text = stacks
    lat, _, depth = _inputs(3)
    seen = set()
    for seed in range(20):
        g = torch.Generator().manual_seed(seed)
        t = torch.randint(port.min_step, port.max_step + 1, (1,),
                          generator=g)
        grad = port.sds_grad(torch.from_numpy(lat), t_text,
                             torch.from_numpy(depth),
                             generator=torch.Generator().manual_seed(seed))
        assert torch.equal(grad, port.sds_grad(
            torch.from_numpy(lat), t_text, torch.from_numpy(depth), t=t,
            noise=torch.randn(LAT, generator=g)))
        seen.add(int(t))
    assert (port.min_step, port.max_step) == (100, 500)
    assert min(seen) >= 100 and max(seen) <= 500 and len(seen) > 10


def test_prompt_to_img(stacks):
    ref, port, _, _ = stacks
    rng = np.random.default_rng(4)
    depth = rng.random((1, 1, 40, 36)).astype(np.float32)
    r = ref.prompt_to_img(PROMPT, jnp.asarray(depth), height=32, width=32,
                          num_inference_steps=3, seed=2)
    got = port.prompt_to_img(PROMPT, torch.from_numpy(depth), height=32,
                             width=32, num_inference_steps=3,
                             latents=_normal(jax.random.PRNGKey(2), LAT))
    assert got.dtype == np.uint8 and got.shape == r.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - r.astype(int)).max() <= 1


def test_build_models_passes_the_timestep_knobs():
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        Zero123PlusTeacher

    cfg = config_from_dict({
        "render": {"train_grid_size": 32},
        "guide": {"shape_path": str(TORUS), "texture_resolution": 16},
        "optim": {"min_timestep": 0.3, "max_timestep": 0.7,
                  "no_noise": True}})
    _, _, _, sd, _ = build_models(
        cfg, tiny=True, device="cpu",
        teacher=Zero123PlusTeacher(tiny=True, device="cpu"),
        mlp=NeRF2D(device="cpu"))
    assert (sd.min_step, sd.max_step, sd.no_noise) == (300, 700, True)
    default = StableDiffusionDepth(tiny=True, device="cpu")
    assert (default.min_step, default.max_step, default.no_noise) == \
        (20, 980, False)
