"""The port's eval and export path (models.textured_mesh `apply_median_fill`,
`render_texture`, `get_texture_map_only_valid_areas`, `export_mesh`;
training.trainer `eval_frame`; training.views_dataset; ops.view_consistency;
ops.image's eval helpers; raster.render's background types) against the JAX
reference's functions, on the CPU, at small sizes, with inputs made from a
numpy seed and the same MLP weights (through weights.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import GuideConfig as JGuideConfig
from contexture_nerf_tpu.models.textured_mesh import \
    TexturedMeshModel as JTexturedMeshModel
from contexture_nerf_tpu.ops import image as jimage
from contexture_nerf_tpu.ops.view_consistency import \
    compute_view_consistency as j_consistency
from contexture_nerf_tpu.raster import render as jrender
from contexture_nerf_tpu.training import views_dataset as jviews
from contexture_nerf_tpu.training.trainer import ConTEXTure as JConTEXTure
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import GuideConfig, RenderConfig
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops import image as timage
from contexture_nerf_tpu_torch.ops.view_consistency import \
    compute_view_consistency
from contexture_nerf_tpu_torch.raster import render as trender
from contexture_nerf_tpu_torch.training import views_dataset as tviews
from contexture_nerf_tpu_torch.training.trainer import eval_frame
from tools.make_shapes import uv_sphere, write_obj

TEX = 16  # texture lattice of the models below
DIM = 48  # eval render size


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else \
        np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A UV sphere (non-overlapping UV charts), the JAX and the port's mesh
    models over it, and one MLP's weights in both."""
    d = tmp_path_factory.mktemp("eval")
    path = str(d / "sphere.obj")
    write_obj(path, *uv_sphere(8, 12))
    jm = JTexturedMeshModel(JGuideConfig(shape_path=path),
                            render_grid_size=DIM, texture_resolution=TEX,
                            backend="xla")
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = TexturedMeshModel(GuideConfig(shape_path=path),
                           render_grid_size=DIM, texture_resolution=TEX,
                           device="cpu")
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm, mlp, d


# -- the median fill ---------------------------------------------------------------

def _texture(painted: int, res: int = 24):
    """A (1,3,res,res) texture with exactly `painted` texels away from the
    default colour, the others within 0.1 (L1) of it."""
    rng = np.random.default_rng(painted)
    tex = np.empty((1, 3, res, res), np.float32)
    default = np.array([0.8, 0.1, 0.8], np.float32).reshape(3, 1)
    near = default + rng.uniform(-0.03, 0.03, (3, res * res))
    far = rng.uniform(0.0, 1.0, (3, res * res))
    far[1] = rng.uniform(0.4, 1.0, res * res)  # green >= 0.3 away
    pick = np.zeros(res * res, bool)
    pick[rng.permutation(res * res)[:painted]] = True
    tex[0] = np.where(pick, far, near).reshape(3, res, res)
    return tex


@pytest.mark.parametrize("painted", [101, 100, 0],
                         ids=["odd", "even", "none"])
def test_median_fill_matches_reference_exactly(models, painted):
    jm, _, tm, _, _ = models
    tex = _texture(painted)
    got = tm.apply_median_fill(_t(tex))
    ref = torch.from_numpy(np.array(jm.apply_median_fill(
        jnp.asarray(tex))))
    assert torch.equal(got, ref)
    if painted == 0:  # nothing painted: every texel becomes 0
        assert not bool(got.any())
    else:  # the lower median of the painted texels, channel by channel
        flat = tex[0].reshape(3, -1)
        default = np.array([0.8, 0.1, 0.8], np.float32)[:, None]
        mask = np.abs(flat - default).sum(0) >= 0.1
        med = np.sort(flat[:, mask], axis=1)[:, (mask.sum() - 1) // 2]
        assert np.array_equal(_np(got)[0].reshape(3, -1)[:, ~mask][:, 0],
                              med)


# -- the eval render -----------------------------------------------------------------

POSES = [(np.deg2rad(60.0), np.deg2rad(a), 1.5 * 1.2) for a in (0, 137)]


@pytest.mark.parametrize("use_median", [False, True],
                         ids=["lattice", "median"])
def test_eval_render_matches_reference(models, use_median):
    """The eval render body (white background, the default colour shaded
    by the z normal, clipped) at 48^2 on two turntable poses. Pixels are
    compared where both rasterizers picked the same face: there the UVs
    differ by the camera rounding that tests/test_torch_raster.py bounds
    (up to ~3e-4 on faces seen edge-on, 5e-4 with margin), and a bilinear
    sample of the 16^2 texture moves by at most |dUV| x 16 texels x the
    texture's largest step between neighbours, on top of the lattice's
    own f32 MLP noise (5e-5, as tests/test_torch_mlp.py holds
    texture_from_mlp)."""
    jm, params, tm, mlp, _ = models
    j_body = JConTEXTure._build_eval_render(
        types.SimpleNamespace(mesh_model=jm), DIM, use_median)
    with torch.no_grad():
        tex, _ = tm.get_texture_map(mlp)
    if use_median:
        tex = tm.apply_median_fill(tex)
    step = float(torch.maximum(tex.diff(dim=2).abs().amax(),
                               tex.diff(dim=3).abs().amax()))
    tol = 5e-4 * TEX * step + 5e-5
    for th, ph, r in POSES:
        rgb, depth, zn = eval_frame(tm, tex, [th], [ph], [r], DIM)
        j_rgb, j_tex, j_depth, j_zn = j_body(
            params, jnp.asarray([th], jnp.float32),
            jnp.asarray([ph], jnp.float32), jnp.asarray([r], jnp.float32))
        j_idx = np.asarray(jm.render_geometry(th, ph, r,
                                              dims=(DIM, DIM)).face_idx)
        t_idx = _np(tm.render_geometry([th], [ph], [r],
                                       dims=(DIM, DIM)).face_idx)
        same = t_idx == j_idx
        assert same.mean() > 0.99
        np.testing.assert_allclose(
            np.where(same[..., None], _np(rgb), 0),
            np.where(same[..., None], np.asarray(j_rgb), 0), atol=tol,
            rtol=0)
        np.testing.assert_allclose(
            np.where(same[:, None], _np(zn), 0),
            np.where(same[:, None], np.asarray(j_zn), 0), atol=2e-5)
        np.testing.assert_allclose(
            np.where(same[..., None], _np(depth), 0),
            np.where(same[..., None], np.asarray(j_depth), 0), atol=1e-3)
        # the texture of the eval graph: the lattice through the MLP (f32
        # in both; the frameworks sum the matmuls in other orders)
        np.testing.assert_allclose(_np(tex.permute(0, 2, 3, 1).clamp(0, 1)),
                                   np.asarray(j_tex), atol=5e-5)


def test_render_with_white_background_matches_render_texture(models):
    """`render` with the median fill and a white background is
    `render_texture` of the filled map: what the eval hoists out of its
    frames changes no pixel."""
    _, _, tm, mlp, _ = models
    th, ph, r = POSES[1]
    full = tm.render(mlp, theta=[th], phi=[ph], radius=[r],
                     background="white", use_median=True, dims=(DIM, DIM))
    tex = tm.apply_median_fill(tm.get_texture_map(mlp)[0])
    hoisted = tm.render_texture(tex, theta=[th], phi=[ph], radius=[r],
                                background="white", dims=(DIM, DIM))
    for k in ("image", "mask", "depth", "normals", "texture_map"):
        assert torch.equal(full[k], hoisted[k]), k


@pytest.mark.parametrize("background", ["none", "white", "random"])
def test_background_types_match_reference(background):
    """Renderer.render_texture_with_cache's background types on a cache
    with a covered and an uncovered half."""
    rng = np.random.default_rng(5)
    B, H, W, T = 2, 6, 7, 5
    mask = np.zeros((B, 1, H, W), np.float32)
    mask[:, :, :, :4] = 1
    uv = rng.random((B, H, W, 2)).astype(np.float32)
    face_idx = np.where(mask[:, 0] > 0, 0, -1).astype(np.int32)
    normals = rng.normal(size=(B, 1, 3)).astype(np.float32)
    tex = rng.random((1, 3, T, T)).astype(np.float32)
    noise = rng.random((1, 1, 1, 3)).astype(np.float32)
    depth = rng.random((B, 1, H, W)).astype(np.float32)
    common = dict(camera_transform=None, raw_depth_map=None,
                  face_vertices_image=None, bary=None)
    tc = trender.RenderCache(uv_features=_t(uv), face_normals=_t(normals),
                             face_idx=_t(face_idx), depth_map=_t(depth),
                             mask=_t(mask), **common)
    jc = jrender.RenderCache(uv_features=jnp.asarray(uv),
                             face_normals=jnp.asarray(normals),
                             face_idx=jnp.asarray(face_idx),
                             depth_map=jnp.asarray(depth),
                             mask=jnp.asarray(mask), **common)
    got = trender.Renderer((W, H), device="cpu").render_texture_with_cache(
        tc, _t(tex), background, _t(noise))
    ref = jrender.Renderer((W, H), backend="xla").render_texture_with_cache(
        jc, jnp.asarray(tex), background, jnp.asarray(noise))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


# -- poses ---------------------------------------------------------------------------

def test_eval_and_multiview_poses_match_reference():
    cfg = RenderConfig()
    for size in (1, 8, 100):
        assert tviews.ViewsDataset(cfg, size=size).poses() == \
            jviews.ViewsDataset(cfg, size=size).poses()
    assert tviews.ViewsDataset(cfg, size=5, random_views=True,
                               seed=3).poses() == \
        jviews.ViewsDataset(cfg, size=5, random_views=True, seed=3).poses()
    for kw in ({}, {"alternate_views": False}, {"n_views": 5},
               {"views_before": [[30, 60]], "views_after": []}):
        c = RenderConfig(**kw)
        assert tviews.MultiviewDataset(c).poses() == \
            jviews.MultiviewDataset(c).poses()
        assert len(tviews.MultiviewDataset(c)) == \
            len(jviews.MultiviewDataset(c))


@pytest.mark.parametrize("fn", ["rand_poses", "rand_modal_poses"])
def test_random_poses_match_reference(fn):
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(40):
        assert getattr(tviews, fn)(1, rt) == getattr(jviews, fn)(1, rj)
    assert getattr(tviews, fn)(4, rt) == getattr(jviews, fn)(4, rj)


# -- view consistency ------------------------------------------------------------------

def _consistency_inputs(models, dims=24):
    """The sphere's 6 target views at dims^2 through the port's renderer,
    and views coloured by the MLP composited on grey (as the metric does)."""
    _, _, tm, mlp, _ = models
    from contexture_nerf_tpu_torch.training.trainer import view_angles

    th, ph, r = view_angles(RenderConfig())
    cache = tm.render_geometry(th[1:], ph[1:], r[1:], dims=(dims, dims))
    V = cache.face_idx.shape[0]
    with torch.no_grad():
        rgb = tm.query_texture_at_uv(mlp, cache.uv_features.reshape(-1, 2))
    imgs = rgb.reshape(V, dims, dims, 3).permute(0, 3, 1, 2)
    imgs = imgs * cache.mask + 0.5 * (1 - cache.mask)
    return imgs, tm.faces, cache.face_idx, cache.face_vertices_image


def _both(imgs, faces, face_idx, fvi, n=None):
    got = compute_view_consistency(imgs, faces, face_idx, fvi, n_vertices=n)
    ref = j_consistency(jnp.asarray(_np(imgs)), jnp.asarray(_np(faces)),
                        jnp.asarray(_np(face_idx)), jnp.asarray(_np(fvi)),
                        n_vertices=n)
    return float(got), float(ref)


def test_view_consistency_matches_reference_on_a_render(models):
    """The 6 target views of the sphere: every vertex is listed by up to
    six faces, so the vertex -> pixel scatter writes duplicates. f32 sums
    over ~10^4 pixel pairs in other orders: rtol 1e-6."""
    imgs, faces, face_idx, fvi = _consistency_inputs(models)
    assert np.bincount(_np(faces).ravel()).max() > 1  # duplicate indices
    got, ref = _both(imgs, faces, face_idx, fvi)
    assert 0.0 < got <= 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    n = int(faces.max()) + 1
    np.testing.assert_allclose(*_both(imgs, faces, face_idx, fvi, n),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_view_consistency_matches_reference_on_random_inputs(seed):
    """Random faces with duplicate vertex indices, random face indices with
    background, NDC coordinates partly out of the frame, 4 views."""
    rng = np.random.default_rng(seed)
    V, C, H, W, F, N = 4, 3, 10, 12, 30, 20
    imgs = rng.random((V, C, H, W)).astype(np.float32)
    faces = rng.integers(0, N, (F, 3))
    face_idx = rng.integers(-1, F, (V, H, W)).astype(np.int32)
    fvi = rng.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32)[
        :, faces]  # projected per vertex, gathered per face
    got, ref = _both(_t(imgs), _t(faces), _t(face_idx), _t(fvi))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # a view pair that shares nothing gives 0
    none = np.full((V, H, W), -1, np.int32)
    assert _both(_t(imgs), _t(faces), _t(none), _t(fvi)) == (0.0, 0.0)


def test_view_consistency_scatter_is_order_independent(models):
    """The vertex -> pixel scatter without accumulation: listing the faces
    in another order changes which duplicate write lands last, and must
    not change the result."""
    imgs, faces, face_idx, fvi = _consistency_inputs(models)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(
        faces.shape[0]))
    inv = torch.argsort(perm)
    a = compute_view_consistency(imgs, faces, face_idx, fvi)
    b = compute_view_consistency(
        imgs, faces[perm], torch.where(face_idx >= 0,
                                       inv[face_idx.clamp(min=0).long()]
                                       .to(face_idx.dtype), face_idx),
        fvi[:, perm])
    assert torch.equal(a, b)


# -- the valid-area texture map and the export -------------------------------------------

def test_texture_map_only_valid_areas_matches_reference(models):
    """The UV charts rasterized at res 32, every z equal. The sphere's UV
    charts do not overlap, so the two rasterizers can disagree only on
    texels on a chart edge (ties between the two faces that share it);
    the coverage must be equal and the colours within the MLP's f32
    noise where both hit."""
    jm, params, tm, mlp, _ = models
    jm.texture_resolution = tm.texture_resolution = 32
    try:
        got = _np(tm.get_texture_map_only_valid_areas(mlp))
        ref = np.asarray(jm.get_texture_map_only_valid_areas(params))
    finally:
        jm.texture_resolution = tm.texture_resolution = TEX
    assert got.shape == ref.shape == (1, 3, 32, 32)
    cov_t, cov_j = np.any(got != 0, axis=1), np.any(ref != 0, axis=1)
    assert np.array_equal(cov_t, cov_j)
    assert 0.3 < cov_t.mean() < 1.0
    # an edge texel's UV is the same point whichever face it is taken on
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_export_mesh_matches_reference(models, tmp_path):
    """mesh.obj and mesh.mtl byte for byte; albedo.png within 1 per
    channel (uint8 truncation of the f32 MLP's colours)."""
    from PIL import Image

    jm, params, tm, mlp, _ = models
    tm.export_mesh(tmp_path / "t", mlp)
    jm.export_mesh(tmp_path / "j", params)
    for name in ("mesh.obj", "mesh.mtl"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    a = np.asarray(Image.open(tmp_path / "t" / "albedo.png"), np.int32)
    b = np.asarray(Image.open(tmp_path / "j" / "albedo.png"), np.int32)
    assert a.shape == b.shape == (TEX, TEX, 3)
    assert np.abs(a - b).max() <= 1


# -- image helpers ------------------------------------------------------------------------

def test_image_helpers_match_reference():
    rng = np.random.default_rng(4)
    z = rng.random((2, 1, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(timage.color_with_shade([0.85, 0.85, 0.85], _t(z), 0.3)),
        np.asarray(jimage.color_with_shade([0.85, 0.85, 0.85],
                                           jnp.asarray(z), 0.3)))
    x = rng.random((7, 9, 3)).astype(np.float32)
    assert np.array_equal(timage.tensor2numpy(_t(x)),
                          jimage.tensor2numpy(jnp.asarray(x)))
    x[2, 3, 1] = np.nan
    with pytest.raises(ValueError, match="NaNs"):
        timage.tensor2numpy(_t(x))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encoder_round_trips_through_pillow(tmp_path, channels):
    from PIL import Image

    arr = np.random.default_rng(channels).integers(
        0, 256, (13, 17, channels) if channels > 1 else (13, 17),
        dtype=np.uint8)
    p = tmp_path / "x.png"
    p.write_bytes(timage.encode_png(arr))
    assert np.array_equal(np.asarray(Image.open(p)), arr)


def test_save_image_without_pillow_writes_png(tmp_path, monkeypatch):
    """Where Pillow is missing, save_image writes PNG through the port's
    encoder (a .jpg name becomes .png)."""
    import builtins

    from PIL import Image

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **kw)

    arr = np.random.default_rng(9).integers(0, 256, (6, 5, 3),
                                            dtype=np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    out = timage.save_image(arr, tmp_path / "a.jpg")
    monkeypatch.setattr(builtins, "__import__", real)
    assert out == tmp_path / "a.png"
    assert np.array_equal(np.asarray(Image.open(out)), arr)


def test_gif_frames_land_on_the_nearest_palette_colour(tmp_path):
    """The turntable GIF: every frame on the fixed 6 x 7 x 6 palette, each
    channel at its nearest level (within half a level step: 25.5 for 6
    levels, 21.25 for 7). Pillow merges a frame equal to the one before
    into it and adds the durations, so the playing time stays 40 ms a
    frame at 25 fps."""
    from PIL import Image, ImageSequence

    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    frames[1] = frames[0]
    timage.save_gif(frames, tmp_path / "t.gif", fps=25)
    with Image.open(tmp_path / "t.gif") as im:
        seq = [(np.asarray(f.convert("RGB"), np.int32), f.info["duration"])
               for f in ImageSequence.Iterator(im)]
    assert [d for _, d in seq] == [80, 40]
    step = np.array([255 / 5, 255 / 6, 255 / 5])
    pal = np.array(timage.gif_palette()).reshape(-1, 3)
    assert len(pal) == 252
    for (g, _), f in zip(seq, frames[[0, 2]]):
        assert (np.abs(g - f.astype(np.int32)) <= step / 2 + 0.5).all()
        assert (pal[timage.gif_palette_indices(f[None])[0]] == g).all()
