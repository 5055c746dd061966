"""The public entries that the port gained last against the JAX package's,
on the CPU at tiny size, every input made from a seeded numpy generator:
the kaolin-compatible `rasterize` (plain) and
`Renderer.render_multiple_view_texture`, `pixel_grid`,
`Zero123PlusPipeline.teacher_v_pred`, `DDPM`/`PNDM.scale_model_input`,
`split_zero123plus_grid` and `embedder_out_dim`.

Tolerances: `pixel_grid`, the grid split, `scale_model_input` and
`embedder_out_dim` exactly. `rasterize` on the same projected faces is held
by raster_kernel.raster_agreement's rule for the faces (99.99% agree, a
pixel whose face differs must be a z tie or on an edge); where the faces
agree, the barycentrics within 2e-4 and the features within 2e-4 times
sum_k |f_k|: XLA on the CPU contracts the edge functions into FMAs and the
port does not, and a face divides that rounding by its twice-area |den|,
which reaches 9e-5 on the torus's faces at 48^2 (7.9e-5 there, 6.3e-6 on
the random faces). The renderer projects the
vertices itself, in f32 camera math in another order than the reference,
so it is held where both picked one face, to the tolerances of
tests/test_torch_raster.py's geometry test (UVs and raw depth 5e-4, depth
1e-3, normals 2e-5) and the image to 2e-3, those UVs' error times the
slope of a smooth texture (at most ~2.3 per unit of UV). `teacher_v_pred`
within 1e-4 of its output's scale, the teacher tests' tolerance (f32;
XLA and torch sum the convolutions in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.diffusion import schedulers as jsch
from contexture_nerf_tpu.diffusion.zero123plus import Zero123PlusPipeline
from contexture_nerf_tpu.models.fields import \
    embedder_out_dim as j_embedder_out_dim
from contexture_nerf_tpu.ops.grid import split_grid_to_6 as j_split6
from contexture_nerf_tpu.ops.grid import split_zero123plus_grid as j_split
from contexture_nerf_tpu.raster import render as jrender
from contexture_nerf_tpu.raster import rasterize as jrast
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import (RenderConfig,
                                                   config_from_dict)
from contexture_nerf_tpu_torch.diffusion import schedulers as tsch
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusPipeline as TPipeline
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.models import fields
from contexture_nerf_tpu_torch.models import mesh as tmesh
from contexture_nerf_tpu_torch.ops.grid import (split_grid_to_6,
                                                split_zero123plus_grid)
from contexture_nerf_tpu_torch.raster import camera as tcam
from contexture_nerf_tpu_torch.raster import raster_kernel as rk
from contexture_nerf_tpu_torch.raster import rasterize as trast
from contexture_nerf_tpu_torch.raster import render as trender
from contexture_nerf_tpu_torch.training import trainer as tr
from contexture_nerf_tpu_torch.training import views_dataset as tviews
from tools.make_shapes import uv_sphere, write_obj

TORUS = "shapes/torus.obj"
BARY_TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else \
        np.asarray(x)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _views(n=7):
    poses = tviews.Zero123PlusDataset(RenderConfig()).poses()[:n]
    return ([p["theta"] for p in poses], [p["phi"] for p in poses],
            [p["radius"] for p in poses])


def _random_faces(seed, B=2, F=37):
    rng = np.random.default_rng(seed)
    fvi = rng.uniform(-1, 1, (B, F, 3, 2)).astype(np.float32)
    fvz = -rng.uniform(0.5, 2.0, (B, F, 3)).astype(np.float32)
    return fvz, fvi


def _torus_faces():
    m = tmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    th, ph, r = _views()
    ct = tcam.get_camera_from_view(th, ph, r, 0.25)
    fvc, fvi, _ = tcam.prepare_vertices(
        _t(m.vertices), _t(m.faces),
        tcam.perspective_projection(np.pi / 3), ct)
    return _np(fvc[..., 2]), _np(fvi)


# -- geometry ---------------------------------------------------------------------

def test_pixel_grid_equals_the_reference():
    for h, w in ((8, 40), (7, 5), (1, 1)):
        got, ref = trast.pixel_grid(h, w), jrast.pixel_grid(h, w)
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        ys, xs = trast.pixel_centers(h, w)
        np.testing.assert_array_equal(_np(got[0][:, 0]), _np(ys))
        np.testing.assert_array_equal(_np(got[1][0]), _np(xs))


@pytest.mark.parametrize("case", ["random_37", "torus_7x48"])
def test_rasterize_plain_matches_the_reference(case):
    fvz, fvi = _random_faces(1) if case == "random_37" else _torus_faces()
    H, W = (8, 40) if case == "random_37" else (48, 48)
    B, F = fvz.shape[:2]
    rng = np.random.default_rng(2)
    # features: the identity per vertex reads the barycentrics back, then
    # two random channels
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, F, 3, 3))
    feats = np.concatenate(
        [eye, rng.standard_normal((B, F, 3, 2)).astype(np.float32)], -1)
    got, fi = trast.rasterize(H, W, _t(fvz), _t(fvi), _t(feats),
                              backend="plain")
    ref, jfi = jrast.rasterize(H, W, jnp.asarray(fvz), jnp.asarray(fvi),
                               jnp.asarray(feats), backend="xla")
    assert got.shape == (B, H, W, 5) and fi.dtype == torch.int32
    jfi, ref = _t(np.asarray(jfi)), _t(np.asarray(ref))
    a = rk.raster_agreement(fi, got[..., :3], jfi, ref[..., :3], _t(fvz))
    assert a["covered"] > 0 and a["agree"] >= 0.9999 and \
        a["unexplained"] == 0, a
    # where the faces agree: the barycentrics within BARY_TOL, the
    # features within that times sum_k |f_k|
    same = (fi == jfi) & (fi >= 0)
    safe = fi.clamp(min=0).reshape(B, -1, 1, 1).long()
    fsum = _t(feats).abs().gather(1, safe.expand(-1, -1, 3, feats.shape[-1])
                                  ).sum(2).reshape(got.shape)
    berr = (got[..., :3] - ref[..., :3]).abs().amax(-1)
    assert float(berr[same].max()) <= BARY_TOL
    assert bool(((got - ref).abs() <= BARY_TOL * fsum)[same].all())
    assert bool((got[fi < 0] == 0).all())
    # the backend that None picks on the CPU, and the chunk size, change
    # nothing
    for kw in ({}, {"backend": "plain", "face_chunk": 5}):
        again, fi2 = trast.rasterize(H, W, _t(fvz), _t(fvi), _t(feats), **kw)
        assert torch.equal(again, got) and torch.equal(fi2, fi)


def test_rasterize_refuses_the_kernel_on_the_cpu():
    fvz, fvi = _random_faces(3, B=1, F=4)
    feats = torch.ones(1, 4, 3, 1)
    with pytest.raises(ValueError, match="CUDA"):
        trast.rasterize(8, 8, _t(fvz), _t(fvi), feats, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        trast.rasterize(8, 8, _t(fvz), _t(fvi), feats, backend="pallas")


def _smooth_texture(res=32):
    u = np.linspace(0, 1, res, dtype=np.float32)
    uu, vv = np.meshgrid(u, u)
    ch = [0.5 + 0.25 * np.sin(2 * np.pi * uu + c) * np.cos(2 * np.pi * vv)
          for c in (0.0, 1.0, 2.0)]
    return np.stack(ch)[None].astype(np.float32)  # (1, 3, res, res)


@pytest.mark.parametrize("background", ["none", "white"])
def test_render_multiple_view_texture_matches_the_reference(background):
    m = tmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    uv = m.vt[m.ft][None]
    th, ph, r = _views()
    tex = _smooth_texture()
    renderer = trender.Renderer((48, 48), device="cpu")
    args = (_t(m.vertices), _t(m.faces), _t(uv).expand(7, -1, -1, -1),
            _t(tex), th, ph, r)
    got = renderer.render_multiple_view_texture(
        *args, look_at_height=0.25, background_type=background)
    ref = jrender.Renderer((48, 48), backend="xla") \
        .render_multiple_view_texture(
            jnp.asarray(m.vertices), jnp.asarray(m.faces),
            jnp.broadcast_to(jnp.asarray(uv), (7,) + uv.shape[1:]),
            jnp.asarray(tex), jnp.asarray(th), jnp.asarray(ph),
            jnp.asarray(r), look_at_height=0.25, background_type=background)
    cache = got[4]
    # the port's entry is its geometry pass, then its texture pass
    want = renderer.render_texture_with_cache(
        renderer.render_geometry(*args[:3], th, ph, r, look_at_height=0.25),
        _t(tex), background)
    for a, b in zip(got[:4], want):
        assert torch.equal(a, b)
    # with a cache given, only the texture pass runs
    again = renderer.render_multiple_view_texture(
        None, None, None, _t(tex), background_type=background,
        render_cache=cache)
    assert again[4] is cache
    for a, b in zip(again[:4], got[:4]):
        assert torch.equal(a, b)
    # against the reference where both picked one face
    jfi = _t(np.asarray(ref[4].face_idx))
    a = rk.raster_agreement(cache.face_idx, cache.bary, jfi,
                            _t(np.asarray(ref[4].bary)),
                            renderer.project(*args[:2], th, ph, r,
                                             0.25)[1][..., 2])
    assert rk.agreement_ok(a, bary_tol=1e-3), a
    same = _np(cache.face_idx == jfi)[:, None]
    for name, k, tol in (("image", 0, 2e-3), ("mask", 1, 0.0),
                         ("depth", 2, 1e-3), ("normals", 3, 2e-5)):
        np.testing.assert_allclose(np.where(same, _np(got[k]), 0),
                                   np.where(same, np.asarray(ref[k]), 0),
                                   atol=tol, rtol=0, err_msg=name)
    if background == "white":
        assert bool((got[0][:, :, ~_np(same[:, 0]).any(0)] >= 0).all())


# -- the teacher ------------------------------------------------------------------

def _perturbed(tree, seed):
    """Every leaf moved off its init (the zero-initialized ControlNet heads
    too), as numpy f32."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(fan_in)
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def teacher_pair():
    pipe = Zero123PlusPipeline(tiny=True)
    params = {k: _perturbed(pipe.params[k], i)
              for i, k in enumerate(("unet", "controlnet", "vae"))}
    pipe.params = dict(pipe.params,
                       **{k: jax.tree.map(jnp.asarray, v)
                          for k, v in params.items()})
    port = TPipeline(tiny=True, device="cpu")
    weights.load_teacher(port, params)
    return pipe, port


def test_teacher_v_pred_matches_the_reference(teacher_pair):
    pipe, port = teacher_pair
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    cl = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ehs = rng.standard_normal((2, 77, 32)).astype(np.float32)
    depth = rng.random((1, 3, 48, 32)).astype(np.float32)
    t = np.array([500])
    key = jax.random.PRNGKey(6)
    # the reference's write-pass draws, as its _cfg_core takes them
    k_neg, k_cond = jax.random.split(key)
    neg = np.asarray(jax.random.normal(k_neg, cl.shape[1:]))
    cnd = np.asarray(jax.random.normal(k_cond, cl.shape[1:]))
    ref = pipe.teacher_v_pred(jnp.asarray(lat), jnp.asarray(t),
                              jnp.asarray(cl), jnp.asarray(ehs),
                              jnp.asarray(depth), 10.0, key)
    args = (_t(lat), _t(t), _t(cl), _t(ehs), _t(depth))
    got = port.teacher_v_pred(*args, 10.0, _t(neg), _t(cnd))
    _close(got, ref, 1e-4)
    # the same call as the step's: _cfg_v_pred with no input scale
    assert torch.equal(got, port._cfg_v_pred(*args, 10.0, _t(neg), _t(cnd)))
    # draws from a generator: neg, then cond
    g = torch.Generator().manual_seed(3)
    drawn = port.teacher_v_pred(*args, 10.0, generator=g)
    g = torch.Generator().manual_seed(3)
    noises = [torch.randn(cl.shape[1:], generator=g) for _ in range(2)]
    assert torch.equal(drawn, port.teacher_v_pred(*args, 10.0, *noises))
    # the guidance scale reaches the output
    assert not torch.allclose(port.teacher_v_pred(*args, 1.0, *noises),
                              drawn)
    with pytest.raises(ValueError, match="generator"):
        port.teacher_v_pred(*args, 10.0)


def test_the_sds_step_calls_teacher_v_pred(monkeypatch, tmp_path):
    """SDSTrainer.step's teacher call is teacher_v_pred with the step's
    write-pass draws and the trainer's guidance scale."""
    calls = []
    real = Zero123PlusTeacher.teacher_v_pred

    def spy(self, *a, **k):
        calls.append((a, k))
        return real(self, *a, **k)

    monkeypatch.setattr(Zero123PlusTeacher, "teacher_v_pred", spy)
    write_obj(tmp_path / "s.obj", *uv_sphere(6, 8))
    cfg = config_from_dict({
        "log": {"exp_name": "p", "exp_root": str(tmp_path / "exp")},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "t", "shape_path": str(tmp_path / "s.obj"),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": 1}})
    sds, _ = tr.build_sds_trainer(cfg, tiny=True, device="cpu",
                                  skip_bootstrap=True)
    shape = sds.latent_shape()
    cshape = tuple(sds.cond_lat_pair.shape[1:])
    draws = {"tile_idx": torch.tensor([2]),
             "eps": torch.zeros(shape).to(sds.dtype),
             "noise": torch.zeros(shape),
             "neg_noise": torch.full(cshape, 0.5),
             "cond_noise": torch.full(cshape, -0.5)}
    sds.step(400, draws)
    assert len(calls) == 1
    a, k = calls[0]
    assert a[5] == tr.GUIDANCE_SCALE
    assert torch.equal(a[6], draws["neg_noise"])
    assert torch.equal(a[7], draws["cond_noise"])
    assert k["cn_cond_emb"] is sds.cn_cond_emb


# -- schedulers, grid, fields -----------------------------------------------------

@pytest.mark.parametrize("name", ["DDPM", "PNDM"])
def test_scale_model_input_returns_the_sample(name):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    port = getattr(tsch, name).create(device="cpu")
    ref = getattr(jsch, name).create()
    got = port.scale_model_input(_t(x), 500)
    assert torch.equal(got, _t(x))
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(ref.scale_model_input(
                                      jnp.asarray(x), 500)))


def test_split_zero123plus_grid_matches_the_reference_and_split_6():
    rng = np.random.default_rng(9)
    t = 5
    grid = rng.standard_normal((1, 3, 3 * t, 2 * t)).astype(np.float32)
    got = split_zero123plus_grid(_t(grid), t)
    ref = j_split(jnp.asarray(grid), t)
    six = split_grid_to_6(_t(grid), t)
    np.testing.assert_array_equal(_np(six), np.asarray(
        j_split6(jnp.asarray(grid), t)))
    assert len(got) == 3 and all(len(row) == 2 for row in got)
    for r in range(3):
        for c in range(2):
            np.testing.assert_array_equal(_np(got[r][c]),
                                          np.asarray(ref[r][c]))
            # column-major views: row r, column c is view 3 c + r
            assert torch.equal(got[r][c], six[3 * c + r][None])


def test_embedder_out_dim_matches_the_reference():
    for multires in (0, 4, 10):
        for dims in (2, 3):
            for inc in (True, False):
                assert fields.embedder_out_dim(multires, dims, inc) == \
                    j_embedder_out_dim(multires, dims, inc)
    assert fields.embedder_out_dim() == 42 == fields.NeRF2D.INPUT_CH
    uv = torch.rand(5, 2, generator=torch.Generator().manual_seed(0))
    assert fields.fourier_embed(uv, 10).shape[-1] == fields.embedder_out_dim()
