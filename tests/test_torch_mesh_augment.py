"""The rest of the port's TexturedMeshModel against the JAX package's, on
the CPU: the cotangent Laplacian, its eigenpairs, the vertex augmentations
and render_face_normals_face_idx.

The mesh is a closed, randomly perturbed icosphere (no seam duplicates,
no symmetry), so the Laplacian's low eigenvalues are simple and each
eigenvector is defined up to its sign.

Tolerances: the Laplacian is the same numpy arithmetic: equal. The
eigenpairs come from ARPACK (shift-invert, tol 1e-3), started from its own
random vector, which differs from call to call: each package's are held
to numpy's dense eigendecomposition within that tol (eigenvalues relative
to the largest, eigenvectors with signs aligned; over 12 calls the worst
eigenvector error was 3.2e-4, where the closest eigenvalues lie 1.1e-3
apart). The
augmentations, given one eigenbasis and one np.random.Generator seed, are
the same numpy arithmetic: equal. render_face_normals_face_idx: the face
indices within the raster tolerance of tests/test_torch_raster.py
(`raster_agreement`: mismatches only at z ties and edges), and its
tolerances where both picked the same face: normals 2e-5 (unit normals of
small faces from camera-space vertices ~1e-7 apart), the normalized depth
1e-3 (edge-on faces scale the camera math's rounding by 1/den).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import GuideConfig as JGuide
from contexture_nerf_tpu.models.textured_mesh import \
    TexturedMeshModel as JMesh
from contexture_nerf_tpu_torch.core.config import GuideConfig
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.raster import raster_kernel as rk
from contexture_nerf_tpu_torch.tools.make_shapes import write_obj

ARPACK_TOL = 1e-3  # eigsh's tol in both packages' eigens


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def icosphere(subdivisions: int, rng: np.random.Generator):
    """A unit icosphere, subdivided, each vertex moved radially by up to
    15% and stretched along x; per-vertex spherical UVs."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
         (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdivisions):
        mids, faces = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = faces
    verts = np.asarray(verts)
    verts = verts * (1 + 0.15 * rng.random((len(verts), 1)))
    verts[:, 0] *= 1.3
    uv = np.stack([np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(verts[:, 1] / np.linalg.norm(
                       verts, axis=1), -1, 1)) / np.pi], 1)
    faces = np.asarray(f, np.int64)
    return verts.astype(np.float32), faces, uv.astype(np.float32), faces


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    path = tmp_path_factory.mktemp("aug") / "blob.obj"
    write_obj(path, *icosphere(2, np.random.default_rng(3)))
    jm = JMesh(JGuide(shape_path=str(path)), render_grid_size=48,
               texture_resolution=16, backend="xla")
    tm = TexturedMeshModel(GuideConfig(shape_path=str(path)),
                           render_grid_size=48, texture_resolution=16,
                           device="cpu")
    return jm, tm


def test_cotan_laplacian_is_the_reference(meshes):
    jm, tm = meshes
    a, b = jm.cotan_laplacian(), tm.cotan_laplacian()
    assert a.shape == b.shape and b.format == "csc"
    np.testing.assert_array_equal(b.toarray(), a.toarray())


def test_eigenpairs_match_up_to_sign(meshes):
    """Both packages' eigenpairs against numpy's dense eigendecomposition
    of the same shifted Laplacian, to ARPACK's tolerance."""
    jm, tm = meshes
    L = tm.cotan_laplacian().toarray()
    w, V = np.linalg.eigh(L + 1e-4 * np.eye(L.shape[0]))
    w, V = w[1:21] + 1e-4, V[:, 1:21].T  # the shift added back, as eigens
    assert np.diff(w).min() > 1e-4 * w.max()  # simple eigenvalues
    for vals, vecs in (jm.eigens(20, 0.0), tm.eigens(20, 0.0)):
        assert vals.shape == (20,) and vecs.shape == V.shape
        np.testing.assert_allclose(vals, w, rtol=0, atol=ARPACK_TOL * w.max())
        sign = np.sign(np.sum(vecs * V, axis=1))[:, None]
        np.testing.assert_allclose(vecs * sign, V, rtol=0, atol=ARPACK_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_augmentations_are_the_reference_under_one_generator(meshes, seed,
                                                             monkeypatch):
    jm, tm = meshes
    basis = jm.eigens(20, 0.0)
    monkeypatch.setattr(jm, "eigens", lambda k=20, e=0.0: basis)
    monkeypatch.setattr(tm, "eigens", lambda k=20, e=0.0: basis)
    a = jm.augment_vertices(np.random.default_rng(seed))
    b = tm.augment_vertices(np.random.default_rng(seed))
    np.testing.assert_array_equal(b, a)
    v = np.asarray(tm.mesh.vertices)
    np.testing.assert_array_equal(
        tm.axis_augmentations(v, np.random.default_rng(seed)),
        jm.axis_augmentations(v, np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        tm.spectral_augmentations(v, np.random.default_rng(seed)),
        jm.spectral_augmentations(v, np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        tm.normalize_vertices(v, 0.7, 0.1), jm.normalize_vertices(v, 0.7,
                                                                  0.1))


def test_render_face_normals_face_idx(meshes):
    jm, tm = meshes
    theta = np.array([1.0, 1.2, 0.6], np.float32)
    phi = np.array([0.0, 2.0, 4.0], np.float32)
    radius = np.array([1.5, 1.6, 1.4], np.float32)
    ref = jm.render_face_normals_face_idx(jnp.asarray(theta),
                                          jnp.asarray(phi),
                                          jnp.asarray(radius))
    got = tm.render_face_normals_face_idx(torch.from_numpy(theta),
                                          torch.from_numpy(phi),
                                          torch.from_numpy(radius))
    shapes = [tuple(np.asarray(r).shape) for r in ref]
    assert [tuple(g.shape) for g in got] == shapes
    mask, depth, normals, face_normals, face_idx = got
    fvz = tm.project(torch.from_numpy(theta), torch.from_numpy(phi),
                     torch.from_numpy(radius))[1][..., 2]
    cache = tm.render_geometry(torch.from_numpy(theta), torch.from_numpy(phi),
                               torch.from_numpy(radius))
    jcache = jm.render_geometry(jnp.asarray(theta), jnp.asarray(phi),
                                jnp.asarray(radius))
    a = rk.raster_agreement(face_idx[:, 0], cache.bary,
                            torch.from_numpy(np.asarray(ref[4])[:, 0]),
                            torch.from_numpy(np.asarray(jcache.bary)), fvz)
    assert rk.agreement_ok(a, bary_tol=1e-3), a
    np.testing.assert_allclose(face_normals.numpy(), np.asarray(ref[3]),
                               atol=2e-5)
    same = (face_idx == torch.from_numpy(np.asarray(ref[4]))).numpy()
    np.testing.assert_array_equal(mask.numpy()[same],
                                  np.asarray(ref[0])[same])
    for got_, ref_, tol in ((normals, ref[2], 2e-5), (depth, ref[1], 1e-3)):
        g = got_.numpy()
        r = np.asarray(ref_)
        sel = np.broadcast_to(same, g.shape)
        np.testing.assert_allclose(g[sel], r[sel], atol=tol)
    assert float(mask.mean()) > 0.05
