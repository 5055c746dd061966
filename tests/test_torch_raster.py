"""The port's geometry path (contexture_nerf_tpu_torch.raster, ops.texture,
ops.view_weights, ops.image, models.mesh, training.views_dataset) against
the JAX reference's functions, on the CPU, at small sizes, with inputs made
from a numpy seed. The rasterizer's plain version is held against the
reference's XLA scan and its Pallas kernel (interpret mode), each with a
tie- and edge-tolerant check; the same check must reject planted faults.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.models import mesh as jmesh
from contexture_nerf_tpu.ops import image as jimage
from contexture_nerf_tpu.ops.texture import sample_texture as j_sample
from contexture_nerf_tpu.ops.view_weights import \
    compute_view_weights as j_view_weights
from contexture_nerf_tpu.raster import camera as jcam
from contexture_nerf_tpu.raster import render as jrender
from contexture_nerf_tpu.raster import rasterize as jrast
from contexture_nerf_tpu.raster.pallas_raster import rasterize_geometry_pallas
from contexture_nerf_tpu.training import views_dataset as jviews
from contexture_nerf_tpu_torch.core.config import RenderConfig
from contexture_nerf_tpu_torch.models import mesh as tmesh
from contexture_nerf_tpu_torch.ops import image as timage
from contexture_nerf_tpu_torch.ops.texture import sample_texture
from contexture_nerf_tpu_torch.ops.view_weights import compute_view_weights
from contexture_nerf_tpu_torch.raster import camera as tcam
from contexture_nerf_tpu_torch.raster import raster_kernel as rk
from contexture_nerf_tpu_torch.raster import render as trender
from contexture_nerf_tpu_torch.raster import rasterize as trast
from contexture_nerf_tpu_torch.training import views_dataset as tviews

TORUS = "shapes/torus.obj"


def _np(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else \
        np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _views(n=7):
    """The 7 fixed Zero123++ poses (theta, phi, radius)."""
    poses = tviews.Zero123PlusDataset(RenderConfig()).poses()[:n]
    return ([p["theta"] for p in poses], [p["phi"] for p in poses],
            [p["radius"] for p in poses])


def _torus_faces(n_views=7):
    """The torus (normalized as the paint path does) seen from the fixed
    views: camera-space z (B,F,3) and NDC (B,F,3,2), port and JAX."""
    m = tmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    th, ph, r = _views(n_views)
    ct = tcam.get_camera_from_view(th, ph, r, 0.25)
    fvc, fvi, normals = tcam.prepare_vertices(
        _t(m.vertices), _t(m.faces), tcam.perspective_projection(np.pi / 3),
        ct)
    return fvc[..., 2].contiguous(), fvi.contiguous(), normals, m


# -- mesh, poses, camera ---------------------------------------------------------

def test_mesh_load_and_normalize_match_reference():
    t = tmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    j = jmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-6)
    assert np.array_equal(t.faces, j.faces) and np.array_equal(t.ft, j.ft)
    np.testing.assert_allclose(t.vt, j.vt, atol=0)
    np.testing.assert_allclose(t.normals, j.normals, atol=1e-6)
    np.testing.assert_allclose(t.face_area, j.face_area, atol=1e-7)
    assert t.faces.shape == (2304, 3)


def test_poses_and_view_direction_match_reference():
    cfg = RenderConfig()
    t = tviews.Zero123PlusDataset(cfg).poses()
    j = jviews.Zero123PlusDataset(cfg).poses()
    assert t == j
    rng = np.random.default_rng(0)
    th, ph = rng.uniform(0, np.pi, 50), rng.uniform(0, 2 * np.pi, 50)
    assert np.array_equal(timage.get_view_direction(th, ph, 0.7, 1.2),
                          jimage.get_view_direction(th, ph, 0.7, 1.2))


def test_camera_matches_reference():
    rng = np.random.default_rng(1)
    th, ph, r = _views()
    ct = tcam.get_camera_from_view(th, ph, r, 0.25)
    jct = jcam.get_camera_from_view(jnp.asarray(th), jnp.asarray(ph),
                                    jnp.asarray(r), 0.25)
    np.testing.assert_allclose(_np(ct), np.asarray(jct), atol=1e-6)
    proj = tcam.perspective_projection(np.pi / 3)
    np.testing.assert_allclose(_np(proj),
                               np.asarray(jcam.perspective_projection(
                                   np.pi / 3)), atol=1e-7)
    verts = rng.uniform(-0.6, 0.6, (40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (30, 3))
    out = tcam.prepare_vertices(_t(verts), _t(faces), proj, ct)
    ref = jcam.prepare_vertices(jnp.asarray(verts), jnp.asarray(faces),
                                jcam.perspective_projection(np.pi / 3), jct)
    # f32 camera math in other summation orders
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-6)


# -- rasterizer pieces -------------------------------------------------------------

def test_face_edge_setup_matches_reference():
    fvi = np.random.default_rng(2).uniform(-1, 1, (2, 9, 3, 2)).astype(
        np.float32)
    for a, b in zip(trast.face_edge_setup(_t(fvi)),
                    jrast.face_edge_setup(jnp.asarray(fvi))):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


def _random_faces(rng, B, F, spread=1.0):
    v = rng.uniform(-spread, spread, (B, F, 3, 2)).astype(np.float32)
    z = -rng.uniform(0.5, 2.0, (B, F, 3)).astype(np.float32)
    return z, v


def test_plain_rasterizer_matches_reference_xla():
    rng = np.random.default_rng(3)
    z, v = _random_faces(rng, 2, 150)
    v[:, 7] = v[:, 7, :1]  # a degenerate face is never hit
    fi, bary = trast.rasterize_geometry(_t(z), _t(v), 24, 40, face_chunk=32)
    jfi, jbary = jrast.rasterize_geometry(jnp.asarray(z), jnp.asarray(v), 24,
                                          40, face_chunk=64)
    a = rk.raster_agreement(fi, bary, _t(np.asarray(jfi)),
                            _t(np.asarray(jbary)), _t(z))
    assert rk.agreement_ok(a), a
    assert a["covered"] > 1000
    assert not bool((fi == 7).any())


def test_plain_rasterizer_matches_reference_pallas_interpret():
    """A ragged size (40 x 37 pixels, 45 faces: none a multiple of the
    Pallas kernel's 8x128 tile or 128-face chunk). The Pallas path may pick
    another of two coincident faces, so z ties are allowed."""
    rng = np.random.default_rng(4)
    z, v = _random_faces(rng, 1, 45)
    z[0, 10], v[0, 10] = z[0, 3], v[0, 3]  # two coincident faces
    fi, bary = trast.rasterize_geometry(_t(z), _t(v), 40, 37)
    pfi, pbary = rasterize_geometry_pallas(jnp.asarray(z), jnp.asarray(v),
                                           40, 37, interpret=True)
    a = rk.raster_agreement(fi, bary, _t(np.asarray(pfi)),
                            _t(np.asarray(pbary)), _t(z))
    assert rk.agreement_ok(a), a
    # the port keeps the lower index of the coincident pair
    assert not bool((fi == 10).any()) and bool((fi == 3).any())


def test_agreement_check_rejects_planted_faults():
    """The limits K5 is held to on the card reject the two faults planted
    there, here through the plain version on the torus's 7 views: the z
    test reversed (the farthest face wins) and the last face chunk
    dropped."""
    fvz, fvi, _, _ = _torus_faces()
    H = W = 96
    fi, bary = trast.rasterize_geometry(fvz, fvi, H, W)
    assert rk.agreement_ok(rk.raster_agreement(fi, bary, fi, bary, fvz))
    far = trast.rasterize_geometry(-fvz, fvi, H, W)
    a = rk.raster_agreement(*far, fi, bary, fvz)
    assert not rk.agreement_ok(a) and a["unexplained"] > 100, a
    keep = fvz.shape[1] - 64
    drop = trast.rasterize_geometry(fvz[:, :keep], fvi[:, :keep], H, W)
    a = rk.raster_agreement(*drop, fi, bary, fvz)
    assert not rk.agreement_ok(a) and a["unexplained"] > 0, a


def test_face_records_and_dispatch():
    fvz, fvi, _, _ = _torus_faces(2)
    fvi = fvi.clone()
    fvi[0, 5] = fvi[0, 5, :1]  # degenerate
    rec, box = rk.face_records(fvz, fvi)
    assert rec.shape == fvz.shape[:2] + (rk.REC,) and box.shape[-1] == 4
    assert bool(torch.isinf(box[0, 5]).all())
    ok = torch.ones(box.shape[:2], dtype=torch.bool)
    ok[0, 5] = False
    x, y = fvi[..., 0], fvi[..., 1]
    assert bool(((box[..., 0] < x.amin(-1)) & (box[..., 1] > x.amax(-1))
                 & (box[..., 2] < y.amin(-1)) & (box[..., 3] > y.amax(-1)))
                [ok].all())
    # a CPU tensor takes the plain version (64-face chunks)
    got = rk.rasterize_geometry(fvz, fvi, 20, 30)
    ref = trast.rasterize_geometry(fvz, fvi, 20, 30, face_chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_interpolate_attributes_matches_reference():
    rng = np.random.default_rng(5)
    z, v = _random_faces(rng, 2, 40)
    fi, bary = jrast.rasterize_geometry(jnp.asarray(z), jnp.asarray(v), 16,
                                        20, face_chunk=8)
    feats = rng.standard_normal((2, 40, 3, 4)).astype(np.float32)
    got = trast.interpolate_attributes(_t(np.asarray(fi)),
                                       _t(np.asarray(bary)), _t(feats))
    ref = jrast.interpolate_attributes(fi, bary, jnp.asarray(feats))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def test_normalize_multiple_depth_matches_reference():
    rng = np.random.default_rng(6)
    raw = -rng.uniform(1, 2, (3, 10, 12)).astype(np.float32)
    mask = (rng.random((3, 10, 12)) > 0.4).astype(np.float32)
    mask[2] = 0  # a view without the object
    got = trender.normalize_multiple_depth(_t(raw), _t(mask))
    ref = jrender.normalize_multiple_depth(jnp.asarray(raw), jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_texture_matches_reference(mode):
    rng = np.random.default_rng(7)
    uv = rng.uniform(-0.1, 1.1, (2, 9, 11, 2)).astype(np.float32)
    tex = rng.random((1, 3, 16, 12)).astype(np.float32)
    got = sample_texture(_t(uv), _t(tex), mode)
    ref = j_sample(jnp.asarray(uv), jnp.broadcast_to(jnp.asarray(tex),
                                                     (2, 3, 16, 12)), mode)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def test_compute_view_weights_matches_reference():
    fvz, fvi, normals, _ = _torus_faces()
    fi, _ = trast.rasterize_geometry(fvz, fvi, 40, 40)
    got = compute_view_weights(fi[:, None], normals[..., 2])
    ref = j_view_weights(jnp.asarray(_np(fi))[:, None],
                         jnp.asarray(_np(normals[..., 2])))
    assert np.array_equal(_np(got), np.asarray(ref))
    assert 0 < float(got.float().mean()) < 1


# -- crops -------------------------------------------------------------------------

def test_bbox_and_crop_and_resize_match_reference():
    rng = np.random.default_rng(8)
    mask = np.zeros((60, 50), np.float32)
    mask[12:41, 7:30] = 1
    assert timage.get_nonzero_region_tuple(mask) == \
        jimage.get_nonzero_region_tuple(mask)
    assert timage.get_nonzero_region_tuple(_t(mask)) == \
        jimage.get_nonzero_region_tuple(mask)
    x = rng.random((1, 3, 60, 50)).astype(np.float32)
    for out in (16, 45):  # shrink (antialiased) and enlarge
        bbox = jimage.get_nonzero_region_tuple(mask)
        got = timage.crop_and_resize(_t(x), bbox, out, out)
        ref = jimage.crop_and_resize(jnp.asarray(x), bbox, out, out)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)


def test_render_geometry_matches_reference_renderer():
    """The whole geometry pass (camera, raster, depth, UVs, normals) on the
    torus's 7 views at 48 x 48, against the reference renderer's XLA
    path. Buffers are compared where both picked the same face."""
    m = tmesh.Mesh.load(TORUS).normalize_mesh(target_scale=0.6, dy=0.25)
    uv = m.vt[m.ft][None]
    th, ph, r = _views()
    renderer = trender.Renderer((48, 48), device="cpu")
    cache = renderer.render_geometry(
        _t(m.vertices), _t(m.faces), _t(uv).expand(7, -1, -1, -1), th, ph, r,
        look_at_height=0.25)
    jc = jrender.Renderer((48, 48), backend="xla").render_geometry(
        jnp.asarray(m.vertices), jnp.asarray(m.faces),
        jnp.broadcast_to(jnp.asarray(uv), (7,) + uv.shape[1:]),
        jnp.asarray(th), jnp.asarray(ph), jnp.asarray(r), look_at_height=0.25)
    fvz = renderer.project(_t(m.vertices), _t(m.faces), th, ph, r,
                           0.25)[1][..., 2]
    jfi = _t(np.asarray(jc.face_idx))
    a = rk.raster_agreement(cache.face_idx, cache.bary, jfi,
                            _t(np.asarray(jc.bary)), fvz)
    # the two project the vertices with f32 camera math in other orders,
    # and a face's barycentrics scale that rounding by 1/den: 2.5e-4 on the
    # torus's smallest faces (against its own plain version on the same
    # inputs, the kernel is held to 1e-5)
    assert rk.agreement_ok(a, bary_tol=1e-3), a
    same = _np(cache.face_idx == jfi)
    # on a face seen nearly edge-on each barycentric carries that rounding
    # on its own, so their sum strays from 1 by up to ~3e-4, and so do the
    # interpolated attributes (UVs in [0, 1], z about -1.1); the depth
    # normalization then divides by each view's z range (about 0.5)
    for name, sel, tol in (("uv_features", same[..., None], 5e-4),
                           ("raw_depth_map", same[:, None], 5e-4),
                           ("depth_map", same[:, None], 1e-3),
                           ("mask", same[:, None], 0.0)):
        got, ref = _np(getattr(cache, name)), np.asarray(getattr(jc, name))
        np.testing.assert_allclose(np.where(sel, got, 0),
                                   np.where(sel, ref, 0), atol=tol, rtol=0,
                                   err_msg=name)
    # unit normals of faces ~0.05 across from camera-space vertices that
    # differ by ~1e-7
    np.testing.assert_allclose(_np(cache.face_normals),
                               np.asarray(jc.face_normals), atol=2e-5)
