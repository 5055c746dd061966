"""The masked texture sample and its plan (contexture_nerf_tpu_torch
.ops.texture: `masked_sample_plain`, `texture_plan`, `texture_bwd_plain`,
`sample_texture_masked`, the renderer's `render_texture_with_cache`) on the
CPU, at tiny sizes, against the plain path (`sample_texture` times the
mask, through autograd) and against the JAX reference's `sample_texture`
times the mask (its gradient through `jax.vjp`).

The UVs hold what the exact path's views hold: background pixels at uv
(0, 0) with mask 0, whose four taps clamp onto one texel; object pixels
anywhere in [0, 1]; and pixels whose taps fall outside the texture on each
of its four edges. The plan keeps the in-bounds taps of masked pixels
only; every dropped entry is one the plain path multiplies by 0, so the
plan's backward is the same sum in another (fixed) order: within a few
f32 roundings of autograd's, bit for bit the plan's order written out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.ops.texture import sample_texture as j_sample
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import texture as tx
from contexture_nerf_tpu_torch.raster import render as trender
from contexture_nerf_tpu_torch.raster.render import RenderCache

TH, TW = 12, 10


def _views(seed, B=3, H=9, W=11):
    """uv (B, H, W, 2) and mask (B, 1, H, W): a background at uv (0, 0)
    with mask 0, object pixels in [0, 1], and one row of pixels whose taps
    leave the texture across each edge (u, v at 0 and 1 and just past)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0.0, 1.0, (B, H, W, 2)).astype(np.float32)
    mask = (rng.random((B, 1, H, W)) > 0.35).astype(np.float32)
    edge = np.array([[0.0, 0.5], [1.0, 0.5], [0.5, 0.0], [0.5, 1.0],
                     [-0.02, 0.3], [1.02, 0.7], [0.2, -0.03], [0.8, 1.03],
                     [0.0, 0.0], [1.0, 1.0], [0.01, 0.99]], np.float32)
    uv[0, 0, :len(edge)] = edge[:W]
    mask[0, 0, 0, :len(edge)] = 1.0
    uv[:, -1] = 0.0  # the background row
    mask[:, :, -1] = 0.0
    mask[2] = 0.0  # a view without the object
    return torch.from_numpy(uv), torch.from_numpy(mask)


def _texture(seed, batch=1, permuted=False):
    """(batch, 3, TH, TW) in [0, 1]; `permuted` makes it the (batch, 3, TH,
    TW) view of a (batch, TH, TW, 3) tensor, as the texture MLP hands it."""
    rng = np.random.default_rng(seed + 100)
    t = torch.from_numpy(rng.random((batch, TH, TW, 3)).astype(np.float32))
    return t.permute(0, 3, 1, 2) if permuted else \
        t.permute(0, 3, 1, 2).contiguous()


def _plain_grad(uv, mask, texture, mode, g):
    """d/dtexture of sum(g * sample_texture(uv, texture) * mask), through
    autograd over the plain gathers."""
    t = texture.detach().clone().requires_grad_(True)
    out = tx.sample_texture(uv, t, mode) * mask.permute(0, 2, 3, 1)
    (out.permute(0, 3, 1, 2) * g).sum().backward()
    return t.grad


def _reference(uv, mask, texture, mode, g):
    """The JAX reference's sample_texture times the mask, and its gradient
    for the cotangent g (B, 3, H, W)."""
    B = uv.shape[0]
    tex = jnp.asarray(texture.detach().numpy())

    def f(t):
        full = jnp.broadcast_to(t, (B,) + t.shape[1:])
        out = j_sample(jnp.asarray(uv.numpy()), full, mode)
        return jnp.transpose(out * jnp.asarray(mask.numpy()).transpose(
            0, 2, 3, 1), (0, 3, 1, 2))

    out, vjp = jax.vjp(f, tex)
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g.numpy()))[0])


def _sum_scale(plan, g):
    """Per texel, the sum of |g| |weight| over its entries (3 channels):
    what the rounding of a sum of those terms is measured against."""
    return tx.texture_bwd_plain(plan._replace(weight=plan.weight.abs()),
                                g.abs(), torch.empty(
                                    plan.texture_batch, 3, *plan.size))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_masked_sample_matches_plain_and_reference(mode):
    uv, mask = _views(1)
    tex = _texture(1, permuted=True)
    got = tx.masked_sample_plain(uv, mask, tex, mode)
    want = (tx.sample_texture(uv, tex, mode)
            * mask.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert torch.equal(got, want)
    ref, _ = _reference(uv, mask, tex, mode, torch.zeros_like(got))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert float(got[:, :, -1].abs().max()) == 0.0  # the background row
    assert float(got[2].abs().max()) == 0.0
    if mode == "bilinear":  # half the taps of u or v at 0 or 1 are in
        assert float(got[0, :, 0, :4].abs().min()) > 0


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_plan_backward_matches_autograd_and_reference(mode, batch):
    uv, mask = _views(2)
    tex = _texture(2, batch)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 3) + tuple(uv.shape[1:3])).astype(np.float32))
    plan = tx.texture_plan(uv, mask, (TH, TW), mode, batch)
    got = tx.texture_bwd_plain(plan, g, tex)
    want = _plain_grad(uv, mask, tex, mode, g)
    _, ref = _reference(uv, mask, tex, mode, g)
    # the same terms summed in another order: a few roundings of their sum
    tol = 8 * 2.0 ** -24 * _sum_scale(plan, g) + 1e-30
    assert bool(((got - want).abs() <= tol).all())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert float(want.abs().max()) > 0


def test_plan_keeps_the_in_bounds_taps_of_masked_pixels():
    """Entries sorted by (texel, view, pixel); none of a background pixel
    or of a tap off the texture; every kept (pixel, tap) once; the kept
    share over B H W taps."""
    uv, mask = _views(4)
    B, H, W = uv.shape[:3]
    plan = tx.texture_plan(uv, mask, (TH, TW), "bilinear")
    off = plan.offsets.long()
    texel = torch.repeat_interleave(torch.arange(TH * TW), off[1:] - off[:-1])
    key = texel * (B * H * W) + plan.pixel.long()
    assert torch.equal(key, torch.sort(key).values)
    assert len(set(key.tolist())) == key.numel()
    assert bool((mask.reshape(-1)[plan.pixel.long()] != 0).all())
    want = []
    for p in torch.nonzero(mask.reshape(-1) != 0)[:, 0].tolist():
        for iy, ix, w in tx._taps(uv.reshape(-1, 2)[p:p + 1], TH, TW,
                                  "bilinear"):
            if 0 <= iy < TH and 0 <= ix < TW:
                want.append((int(iy) * TW + int(ix), p, float(w)))
    assert sorted((t, p) for t, p, _ in want) == \
        list(zip(texel.tolist(), plan.pixel.tolist()))
    weight = {(t, p): w for t, p, w in want}
    assert [weight[k] for k in zip(texel.tolist(), plan.pixel.tolist())] \
        == plan.weight.tolist()
    assert plan.kept == len(want) / (B * H * W * 4)
    assert 0 < plan.kept < 1
    # the background's taps all clamp onto (TH - 1, 0): none is kept there
    # from a masked-out pixel
    corner = plan.pixel[off[(TH - 1) * TW]:off[(TH - 1) * TW + 1]].long()
    assert bool((mask.reshape(-1)[corner] != 0).all())


def test_plan_backward_is_its_order_written_out():
    """The segment sum adds each texel's entries' g * weight from 0 in the
    plan's order (the order K7's backward sums in), bit for bit."""
    uv, mask = _views(5)
    B, H, W = uv.shape[:3]
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 3, H, W)).astype(np.float32))
    plan = tx.texture_plan(uv, mask, (TH, TW), "bilinear")
    got = tx.texture_bwd_plain(plan, g, torch.empty(1, 3, TH, TW))
    gp = g.permute(0, 2, 3, 1).reshape(-1, 3)
    off = plan.offsets.tolist()
    want = torch.zeros(TH * TW, 3)
    for t in range(TH * TW):
        acc = torch.zeros(3)
        for k in range(off[t], off[t + 1]):
            acc = acc + gp[plan.pixel[k]] * plan.weight[k]
        want[t] = acc
    assert torch.equal(got, want.reshape(1, TH, TW, 3).permute(0, 3, 1, 2))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_function_with_a_plan_matches_the_plain_path(mode):
    """`sample_texture_masked` with a plan on the CPU: the plain forward
    bit for bit, the plan's backward, the gradient in the texture's own
    (permuted) layout; no kernel launched."""
    uv, mask = _views(7)
    base = _texture(7, permuted=True)
    tex = base.detach().clone().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 3) + tuple(uv.shape[1:3])).astype(np.float32))
    plan = tx.texture_plan(uv, mask, (TH, TW), mode)
    before = dict(_build.launch_counts)
    out = tx.sample_texture_masked(uv, mask, tex, mode, plan)
    (out * g).sum().backward()
    assert _build.launch_counts == before
    assert torch.equal(out, tx.masked_sample_plain(uv, mask, base, mode))
    assert tex.grad.stride() == tex.stride()
    assert torch.equal(tex.grad, tx.texture_bwd_plain(plan, g, base))
    want = _plain_grad(uv, mask, base, mode, g)
    assert bool(((tex.grad - want).abs()
                 <= 8 * 2.0 ** -24 * _sum_scale(plan, g) + 1e-30).all())


def test_without_a_plan_the_cpu_route_is_the_plain_path():
    uv, mask = _views(9)
    tex = _texture(9).requires_grad_(True)
    out = tx.sample_texture_masked(uv, mask, tex)
    assert out.grad_fn is not None and \
        "MaskedSample" not in type(out.grad_fn).__name__
    assert torch.equal(out, tx.masked_sample_plain(uv, mask, tex))


def test_a_plan_of_other_views_or_texture_is_refused():
    uv, mask = _views(10)
    tex = _texture(10)
    plan = tx.texture_plan(uv, mask, (TH, TW), "bilinear")
    for args in ((uv, mask, _texture(10, 3), "bilinear"),
                 (uv, mask, tex, "nearest"),
                 (uv[:2], mask[:2], tex, "bilinear"),
                 (uv, mask, tex[:, :, :-1], "bilinear")):
        with pytest.raises(ValueError):
            tx.sample_texture_masked(*args, plan=plan)
    with pytest.raises(ValueError):
        tx.texture_plan(uv, mask[:, :, :-1], (TH, TW))
    with pytest.raises(ValueError):
        tx.texture_plan(uv, mask, (TH, TW), texture_batch=2)
    with pytest.raises(NotImplementedError):
        tx.texture_plan(uv, mask, (TH, TW), "bicubic")


def test_the_kernels_refuse_cpu_tensors():
    uv, mask = _views(11)
    tex = _texture(11)
    with pytest.raises(ValueError):
        tx.texture_fwd_kernel(uv, mask, tex)
    plan = tx.texture_plan(uv, mask, (TH, TW))
    with pytest.raises(ValueError):
        tx.texture_bwd_kernel(plan, torch.zeros(3, 3, *uv.shape[1:3]), tex)


def test_gradient_layout():
    """The gradient takes the texture's strides where they tile its storage
    (a permuted view), the contiguous ones where they do not (an expanded
    or sliced texture)."""
    t = torch.zeros(1, 5, 6, 3).permute(0, 3, 1, 2)
    assert tx._dense_stride(t) == t.stride()
    e = torch.zeros(1, 3, 5, 6).expand(2, 3, 5, 6)
    assert tx._dense_stride(e) == (90, 30, 6, 1)
    s = torch.zeros(1, 3, 5, 8)[..., :6]
    assert tx._dense_stride(s) == (90, 30, 6, 1)


@pytest.mark.parametrize("background", ["none", "white", "random"])
def test_render_texture_with_cache_keeps_its_cpu_values(background):
    """The renderer's CPU route: the plain sample times the mask, then the
    background, the same values as the NHWC formula it replaced."""
    uv, mask = _views(12)
    B, H, W = uv.shape[:3]
    rng = np.random.default_rng(13)
    face_idx = torch.where(mask[:, 0] > 0, torch.from_numpy(
        rng.integers(0, 4, (B, H, W)).astype(np.int32)), -1)
    normals = torch.from_numpy(rng.standard_normal((B, 4, 3)).astype(
        np.float32))
    cache = RenderCache(
        camera_transform=torch.zeros(B, 4, 3), uv_features=uv,
        face_normals=normals, face_idx=face_idx, depth_map=mask * 0.5,
        raw_depth_map=-mask, face_vertices_image=torch.zeros(B, 4, 3, 2),
        bary=torch.zeros(B, H, W, 3), mask=mask)
    tex = _texture(12, permuted=True)
    noise = torch.from_numpy(rng.random((B, 1, 1, 3)).astype(np.float32))
    r = trender.Renderer((W, H), device="cpu")
    image, m, depth, nrm = r.render_texture_with_cache(cache, tex, background,
                                                       noise)
    mhw = mask.permute(0, 2, 3, 1)
    want = tx.sample_texture(uv, tex) * mhw
    if background == "white":
        want = want + 1.0 * (1 - mhw)
    elif background == "random":
        want = want + noise * (1 - mhw)
    assert torch.equal(image, want.permute(0, 3, 1, 2))
    assert m is mask and depth is cache.depth_map
    assert nrm.shape == (B, 3, H, W)
