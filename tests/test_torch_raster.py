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


# -- K5's binned schedule ------------------------------------------------------------

def _bin(ranges, H, W, gen=None):
    """A plain-torch emulation of K5's binning: (tiles_y, tiles_x, per-tile
    counts, exclusive offsets, face lists) from the setup's tile ranges.
    Counts are exact, the scan is exclusive over (view, row, column) order,
    and each tile's slots are filled in an order that depends on the
    kernel's atomics; with `gen`, each list is shuffled to stand for that."""
    B, F = ranges.shape[:2]
    TY, TX = -(-H // rk.TILE), -(-W // rk.TILE)
    ty = torch.arange(TY)[:, None]
    tx = torch.arange(TX)[None, :]
    r = ranges[..., None, None]
    member = (r[..., 0, :, :] <= tx) & (tx <= r[..., 1, :, :]) & \
        (r[..., 2, :, :] <= ty) & (ty <= r[..., 3, :, :])  # (B, F, TY, TX)
    counts = member.sum(1).reshape(-1)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    lists = torch.empty(int(offsets[-1]), dtype=torch.int64)
    for t, m in enumerate(member.permute(0, 2, 3, 1).reshape(-1, F)):
        faces = m.nonzero()[:, 0]
        if gen is not None:
            faces = faces[torch.randperm(len(faces), generator=gen)]
        lists[offsets[t]:offsets[t + 1]] = faces
    return TY, TX, counts, offsets, lists


def _emulate_binned(fvz, fvi, H, W, seed=0):
    """A plain-torch emulation of K5: the setup (`face_records`,
    `pixel_ranges`, `tile_ranges`), the per-tile lists (`_bin`, in
    shuffled order), and the tile pass, tile by tile: each tile tests its
    pixels against only its list's faces, and each 8x4 block of a tile
    only those whose pixel range meets the block, with the kernel's
    operation order ((x a + y b) + c) / den and (w0 z0 + w1 z1) + w2 z2,
    and keeps the maximum of (z, -face) (NaN z never wins); pixels no face
    covers keep the background."""
    B, F = fvz.shape[:2]
    rec, box = rk.face_records(fvz, fvi)
    pr = rk.pixel_ranges(box, H, W)
    TY, TX, _, offsets, lists = _bin(rk.tile_ranges(box, H, W), H, W,
                                     torch.Generator().manual_seed(seed))
    ys, xs = trast.pixel_centers(H, W)
    idx = torch.full((B, H, W), -1, dtype=torch.int32)
    bary = torch.zeros((B, H, W, 3))
    for t in range(B * TY * TX):
        faces = lists[offsets[t]:offsets[t + 1]]
        if len(faces) == 0:
            continue
        b, ty, tx = t // (TY * TX), t // TX % TY, t % TX
        rows = slice(ty * rk.TILE, min(ty * rk.TILE + rk.TILE, H))
        cols = slice(tx * rk.TILE, min(tx * rk.TILE + rk.TILE, W))
        py, px = torch.meshgrid(ys[rows], xs[cols], indexing="ij")
        py, px = py.reshape(-1, 1), px.reshape(-1, 1)
        iy, ix = torch.meshgrid(torch.arange(H)[rows], torch.arange(W)[cols],
                                indexing="ij")
        bx, by = ix.reshape(-1, 1) // 8 * 8, iy.reshape(-1, 1) // 4 * 4
        q = pr[b, faces]  # (n, 4)
        meets = (q[:, 0] <= bx + 7) & (q[:, 1] >= bx) & \
            (q[:, 2] <= by + 3) & (q[:, 3] >= by)  # the pixel's 8x4 block
        r = rec[b, faces]  # (n, 16)
        den = r[:, 9]
        w = [((px * r[:, k] + py * r[:, 3 + k]) + r[:, 6 + k]) / den
             for k in range(3)]
        inside = meets & (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
        z = (w[0] * r[:, 10] + w[1] * r[:, 11]) + w[2] * r[:, 12]
        z = torch.where(inside & ~torch.isnan(z), z,
                        torch.tensor(float("-inf")))
        zmax = z.max(1, keepdim=True).values
        pick = torch.where(z == zmax, faces, F).min(1).values  # lowest face
        hit = zmax[:, 0] > float("-inf")
        col = (faces[None, :] == pick[:, None]).int().argmax(1)
        wb = torch.stack([wk.gather(1, col[:, None])[:, 0] for wk in w], -1)
        hh, ww = rows.stop - rows.start, cols.stop - cols.start
        idx[b, rows, cols] = torch.where(hit, pick, -1).int().reshape(hh, ww)
        bary[b, rows, cols] = torch.where(hit[:, None], wb, 0.0).reshape(
            hh, ww, 3)
    return idx, bary


def test_emulated_binned_schedule_matches_plain_and_pallas():
    """K5's schedule, emulated in plain torch on the torus's 2 first views
    at 48 x 40: bit-identical to the plain rasterizer, and within the
    tie- and edge-tolerant limits of the JAX Pallas kernel (interpret
    mode)."""
    fvz, fvi, _, _ = _torus_faces(2)
    H, W = 48, 40
    idx, bary = _emulate_binned(fvz, fvi, H, W)
    p_idx, p_bary = trast.rasterize_geometry(fvz, fvi, H, W)
    assert torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
    assert int((idx >= 0).sum()) > 0.1 * idx.numel()
    j_idx, j_bary = rasterize_geometry_pallas(
        jnp.asarray(_np(fvz)), jnp.asarray(_np(fvi)), H, W, interpret=True)
    a = rk.raster_agreement(idx, bary, _t(np.asarray(j_idx)),
                            _t(np.asarray(j_bary)), fvz)
    # the Pallas kernel multiplies by a rounded 1/den; on the torus's
    # smallest faces (den ~1e-3) the edge functions' cancellation error,
    # ~1e-7 of terms near 1, becomes ~1e-4 after the division (5e-5 here),
    # as in test_render_geometry_matches_reference_renderer
    assert rk.agreement_ok(a, bary_tol=1e-3), a


def _coverage_faces(case):
    """(fvz, fvi, H, W) of one coverage case, from a numpy seed: random
    faces in the frame plus the case's own."""
    rng = np.random.default_rng(11)
    H, W = {"tiny_frame": (5, 7), "ragged": (777, 1234)}.get(case, (40, 52))
    z, v = _random_faces(rng, 2, 12, spread=0.9)
    if case == "whole_frame":
        v[0, 3] = [[-3.0, -3.0], [3.0, -3.0], [0.0, 4.0]]
        z[0, 3] = -1.9  # behind the others, so they stay visible
    elif case == "off_screen":
        v[:, :6] += rng.choice([-1.5, 1.5], (2, 6, 1, 2)).astype(np.float32)
    elif case == "degenerate":
        v[0, 2] = v[0, 2, :1]
        v[1, 5, 2] = v[1, 5, 0] + (v[1, 5, 1] - v[1, 5, 0]) * 0.5  # collinear
    elif case == "inf_nan":
        v[0, 4, 1, 0] = np.inf
        v[1, 7, 2, 1] = np.nan
        v[1, 8, 0, 1] = -np.inf
    return _t(z), _t(v), H, W


@pytest.mark.parametrize("case", ["whole_frame", "off_screen", "degenerate",
                                  "inf_nan", "tiny_frame", "ragged"])
def test_tile_lists_cover_every_inside_pair(case):
    """Every (pixel, face) pair the plain version finds inside has that
    face in its pixel's tile list, whatever the face: covering the whole
    frame, partly off-screen, degenerate, with an inf or a NaN vertex, in a
    frame smaller than one tile or a ragged 777 x 1234 one. Faces that
    cannot be hit (degenerate, non-finite) are in no list."""
    fvz, fvi, H, W = _coverage_faces(case)
    B, F = fvz.shape[:2]
    rec, ranges, ntiles = rk.face_setup(fvz, fvi, H, W)
    tiles = torch.div(ranges, rk.TILE, rounding_mode="floor")
    assert torch.equal(tiles, rk.tile_ranges(rk.face_records(fvz, fvi)[1],
                                             H, W))
    TY, TX, counts, offsets, lists = _bin(tiles, H, W)
    assert torch.equal(ntiles, rk.range_tiles(tiles))
    assert int(ntiles.sum()) == int(counts.sum()) == len(lists)
    listed = torch.zeros((B, F, TY, TX), dtype=torch.bool)
    for t in range(B * TY * TX):
        b, ty, tx = t // (TY * TX), t // TX % TY, t % TX
        listed[b, lists[offsets[t]:offsets[t + 1]], ty, tx] = True
    ca, cb, cc, den = trast.face_edge_setup(fvi)
    ys, xs = trast.pixel_centers(H, W)
    px, py = xs.repeat(H)[:, None], ys.repeat_interleave(W)[:, None]
    tile = (torch.arange(H) // rk.TILE).repeat_interleave(W) * TX + \
        (torch.arange(W) // rk.TILE).repeat(H)
    hits = 0
    for b in range(B):
        w = [(px * ca[b, :, k] + py * cb[b, :, k] + cc[b, :, k]) / den[b]
             for k in range(3)]
        inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & \
            (den[b].abs() > trast.EPS)  # (P, F)
        hits += int(inside.sum())
        ok = listed[b].reshape(F, -1)[:, tile].T  # (P, F)
        assert not bool((inside & ~ok).any()), case
    assert hits > 0
    dead = ~(den.abs() > trast.EPS) | ~torch.isfinite(fvi).all(-1).all(-1)
    assert bool((ntiles[dead] == 0).all())
    if case in ("whole_frame", "tiny_frame"):
        assert int(counts.max()) >= 1 and bool((counts[:TY * TX] >= 1).all())
    idx, bary = _emulate_binned(fvz, fvi, H, W)
    p_idx, p_bary = trast.rasterize_geometry(fvz, fvi, H, W)
    assert torch.equal(idx, p_idx) and torch.equal(bary, p_bary)


def test_tile_ranges_mirror_the_kernel_arithmetic():
    """`pixel_ranges` and `tile_ranges` on hand-made boxes: a box inside one tile, one across
    tiles, one past the frame on each side, an empty (degenerate) box, and
    non-finite ones. The low edge is floored and the high edge ceiled in
    pixel units before tiles are taken."""
    inf, nan = float("inf"), float("nan")
    H, W = 64, 48  # 4 x 3 tiles; pixel i's centre at (i + 0.5) / 24 - 1
    px = lambda i: (i + 0.5) / 24 - 1  # noqa: E731
    box = torch.tensor([[[px(2), px(3), 0.9, 0.95],  # inside tile (0, 0)
                         [px(14.9), px(33), -1.0, 1.0],
                         [-9.0, 9.0, -9.0, 9.0],
                         [inf, -inf, inf, -inf],
                         [0.0, inf, 0.0, 0.1],
                         [nan, 0.1, 0.0, 0.1],
                         [1.5, 2.0, 0.0, 0.1]]], dtype=torch.float32)
    px_got = rk.pixel_ranges(box, H, W)[0].tolist()
    assert px_got[0][0] <= 2 and px_got[0][1] >= 3  # the box's centres
    assert px_got[2] == [0, W - 1, 0, H - 1]
    got = rk.tile_ranges(box, H, W)[0].tolist()
    assert got[0] == [0, 0, 0, 0]
    assert got[1] == [0, 2, 0, 3]
    assert got[2] == [0, 2, 0, 3]
    for row in got[3:]:
        assert row == list(rk.EMPTY_RANGE)
    assert rk.range_tiles(rk.tile_ranges(box, H, W))[0].tolist() == \
        [1, 12, 12, 0, 0, 0, 0]


def test_planted_binning_fault_is_caught():
    """The binning fault chip_smoke.py plants on the card (every tile range
    one column short at its upper edge), through the same plain emulation
    here on the torus's 7 views at 96 x 96: the emulation with the setup's
    own ranges equals the plain version bit for bit, the shrunk one misses
    K5's limits."""
    from chip_smoke import binned_plain, shrunk_ranges

    fvz, fvi, _, _ = _torus_faces()
    H = W = 96
    p_idx, p_bary = trast.rasterize_geometry(fvz, fvi, H, W)
    ranges = rk.tile_ranges(rk.face_records(fvz, fvi)[1], H, W)
    idx, bary = binned_plain(torch, fvz, fvi, H, W, ranges)
    assert torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
    bad = binned_plain(torch, fvz, fvi, H, W, shrunk_ranges(ranges))
    a = rk.raster_agreement(*bad, p_idx, p_bary, fvz)
    assert not rk.agreement_ok(a) and a["unexplained"] > 0, a
