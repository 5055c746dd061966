"""The port's volume rendering (contexture_nerf_tpu_torch/models/volume.py)
against contexture_nerf_tpu/models/volume.py, on the CPU, f32, from numpy
inputs made with a seed; the random draws are the reference's (its
jax.random uniforms, passed to the port as tensors).

Tolerances: rays, NDC and the stratified depths are a few f32 operations:
1e-6 of their scale. The inverse-CDF samples and the composite run through
a cumulative sum or product, which XLA and torch may associate otherwise:
1e-5. volume_render: 1e-5 on rgb, depth and acc, and on the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.models import volume as JV
from contexture_nerf_tpu_torch.models import volume as TV

RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _camera():
    K = np.array([[40.0, 0, 3.5], [0, 42.0, 2.5], [0, 0, 1]], np.float32)
    a = RNG.standard_normal((3, 3))
    q, _ = np.linalg.qr(a)
    c2w = np.concatenate([q, RNG.standard_normal((3, 1))], 1)
    return K, c2w.astype(np.float32)


def test_get_rays_and_ndc_rays():
    K, c2w = _camera()
    jo, jd = JV.get_rays(5, 7, jnp.asarray(K), jnp.asarray(c2w))
    to, td = TV.get_rays(5, 7, torch.from_numpy(K), torch.from_numpy(c2w))
    _close(to, jo, 1e-6)
    _close(td, jd, 1e-6)
    jo2, jd2 = JV.ndc_rays(5, 7, 40.0, 1.0, jo, jd)
    to2, td2 = TV.ndc_rays(5, 7, 40.0, 1.0, to, td)
    _close(to2, jo2, 1e-5)
    _close(td2, jd2, 1e-5)


@pytest.mark.parametrize("perturb", [True, False])
def test_stratified_samples(perturb):
    key = jax.random.PRNGKey(3)
    jz = JV.stratified_samples(key, 0.5, 2.5, 9, 16, perturb=perturb)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (9, 16)))) \
        if perturb else None
    tz = TV.stratified_samples(0.5, 2.5, 9, 16, u)
    _close(tz, jz, 1e-6)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf(det):
    bins = np.sort(RNG.uniform(0.5, 2.5, (33, 17)), -1).astype(np.float32)
    w = RNG.random((33, 16)).astype(np.float32)
    w[:4] = 0.0  # rays that saw nothing: the 1e-5 floor decides
    key = jax.random.PRNGKey(4)
    jz = JV.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24, det=det)
    u = None if det else torch.from_numpy(np.asarray(
        jax.random.uniform(key, (33, 24))))
    tz = TV.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 24, u)
    _close(tz, jz, 1e-5)


@pytest.mark.parametrize("white", [True, False])
def test_composite(white):
    z = np.sort(RNG.uniform(0.5, 2.5, (20, 12)), -1).astype(np.float32)
    rgb = RNG.standard_normal((20, 12, 3)).astype(np.float32)
    sigma = RNG.standard_normal((20, 12)).astype(np.float32) * 5
    d = RNG.standard_normal((20, 3)).astype(np.float32)
    ref = JV.composite(*(jnp.asarray(a) for a in (rgb, sigma, z, d)), white)
    got = TV.composite(*(torch.from_numpy(a) for a in (rgb, sigma, z, d)),
                       white)
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)


def _ball(lib):
    """A soft ball of radius 0.5 at the origin, coloured by position."""
    def field(pts):
        r = lib.linalg.norm(pts, axis=-1) if lib is jnp else \
            torch.linalg.norm(pts, dim=-1)
        sigma = 50.0 * (1.0 / (1.0 + lib.exp((r - 0.5) * 40.0)))
        return pts * 2.0, sigma
    return field


@pytest.mark.parametrize("n_fine", [0, 32])
def test_volume_render_with_the_reference_draws(n_fine):
    R, n_coarse = 256, 32
    o = np.concatenate([RNG.uniform(-0.3, 0.3, (R, 2)),
                        np.full((R, 1), 1.5)], -1).astype(np.float32)
    d = np.concatenate([RNG.uniform(-0.1, 0.1, (R, 2)),
                        np.full((R, 1), -1.0)], -1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = JV.volume_render(_ball(jnp), jnp.asarray(o), jnp.asarray(d), key,
                           n_coarse=n_coarse, n_fine=n_fine)
    k1, k2 = jax.random.split(key)
    u_c = torch.from_numpy(np.asarray(jax.random.uniform(k1, (R, n_coarse))))
    u_f = torch.from_numpy(np.asarray(jax.random.uniform(k2, (R, n_fine))))
    got = TV.volume_render(_ball(torch), torch.from_numpy(o),
                           torch.from_numpy(d), n_coarse=n_coarse,
                           n_fine=n_fine, u_coarse=u_c, u_fine=u_f)
    for k in ("rgb", "depth", "acc", "weights"):
        _close(got[k], ref[k], 1e-5)
    assert float(got["acc"].max()) > 0.9  # the rays do hit the ball


def test_volume_render_draws_from_its_generator():
    o = torch.tensor([[0.0, 0.0, 1.5]] * 8)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 8)
    runs = [TV.volume_render(_ball(torch), o, d, n_coarse=16, n_fine=8,
                             generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0]["depth"], runs[1]["depth"])
    assert not torch.equal(runs[0]["depth"], runs[2]["depth"])
