"""The port's UV atlas for meshes without UVs (contexture_nerf_tpu_torch
.models.textured_mesh `atlas_unwrap`, `TexturedMeshModel._init_texture_map`)
against the JAX package's: the port's numpy path (native=False) equal to
the reference's numpy path (its C++ unwrap patched away) on a torus, a
spiral ramp (charts demoted to one face each), a flat quad (welded) and a
700-face triangle soup (the per-face fallback); the numpy path against the
C++ unwrap (the same ft, the same geometry inside each chart); the disk
cache, whose file names and contents either package reads (both take their
C++ unwrap; tests/test_torch_objio.py holds the two C++ paths bit for
bit); the order mesh UVs, cache, unwrap; and the CLI painting a mesh
without UVs, then reading its atlas from the cache.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import GuideConfig as JGuideConfig
from contexture_nerf_tpu.models import textured_mesh as jtm
from contexture_nerf_tpu.native import objio
from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch.core.config import GuideConfig
from contexture_nerf_tpu_torch.models import textured_mesh as tm
from tools.make_shapes import torus, uv_sphere, write_obj

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_reference(monkeypatch):
    """The reference's atlas_unwrap on its numpy path: its C++ unwrap
    reports itself unavailable, as tests/test_round2.py does."""
    monkeypatch.setattr(objio, "chart_unwrap_native", lambda *a, **k: None)
    return jtm.atlas_unwrap


def _spiral_ramp(turns=2.0, segs=48):
    """An annular strip winding `turns` times with a gentle slope: every
    normal stays inside a 75-degree cone, yet the turns overlap in the seed
    plane (tests/test_round3.py's ramp)."""
    thetas = np.linspace(0, 2 * np.pi * turns, segs)
    z = 0.02 * thetas
    inner = np.stack([0.8 * np.cos(thetas), 0.8 * np.sin(thetas), z], -1)
    outer = np.stack([1.2 * np.cos(thetas), 1.2 * np.sin(thetas), z], -1)
    verts = np.concatenate([inner, outer]).astype(np.float32)
    faces = []
    for i in range(segs - 1):
        a, b, c, d = i, i + 1, segs + i, segs + i + 1
        faces += [[a, c, b], [b, c, d]]
    return verts, np.asarray(faces, np.int64)


def _soup(F=700):
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (3 * F, 3)).astype(np.float32)
    return v, np.arange(3 * F, dtype=np.int64).reshape(F, 3)


CASES = {
    "torus": (lambda: torus(n_major=24, n_minor=12)[:2], {}),
    "spiral_ramp": (_spiral_ramp, {}),
    "flat_quad": (lambda: (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                     [1, 1, 0]], np.float32),
                           np.array([[0, 1, 2], [1, 3, 2]], np.int64)), {}),
    "triangle_soup": (_soup, {"gutter": 0.02}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_atlas_unwrap_matches_reference_numpy_path(case, numpy_reference):
    make, kw = CASES[case]
    v, f = make()
    vt, ft = tm.atlas_unwrap(v, f, native=False, **kw)
    vt_r, ft_r = numpy_reference(v, f, **kw)
    assert vt.dtype == vt_r.dtype == np.float32
    assert ft.dtype == ft_r.dtype == np.int64
    np.testing.assert_array_equal(ft, ft_r)
    np.testing.assert_array_equal(vt, vt_r)
    assert vt.min() >= 0.0 and vt.max() <= 1.0 and ft.shape == f.shape
    if case == "spiral_ramp":  # the overlapping chart was demoted
        assert tm._overlap_frac(vt, ft, G=256) < 0.02
        assert len(np.unique(tm._charts_from_ft(ft))) > 1
    if case == "flat_quad":  # one welded chart: the diagonal is shared
        assert len(set(ft[0]) & set(ft[1])) == 2
    if case == "triangle_soup":  # the shelves overflow: one cell a face
        per_face, _ = tm._per_face_unwrap(f)
        np.testing.assert_array_equal(vt, per_face)


def test_atlas_unwrap_agrees_with_the_native_unwrap():
    """Both packages prefer their C++ unwrap; the port's numpy path
    (native=False) gives the same ft as the reference's C++ unwrap and,
    inside each chart, the same UVs within 1e-4 (shelf placement may
    differ where equal heights tie)."""
    v, f, _, _ = torus(n_major=24, n_minor=12)
    native = objio.chart_unwrap_native(v, f)
    if native is None:
        pytest.skip("the JAX package's C++ unwrap does not build here")
    vt, ft = tm.atlas_unwrap(v, f, native=False)
    vt_n, ft_n = native
    np.testing.assert_array_equal(ft_n, ft)
    assert vt_n.shape == vt.shape
    chart = tm._grow_charts(v, f, 75.0)
    for cid in range(int(chart.max()) + 1):
        idx = np.unique(ft[chart == cid].reshape(-1))
        np.testing.assert_allclose(vt_n[idx] - vt_n[idx].min(axis=0),
                                   vt[idx] - vt[idx].min(axis=0), atol=1e-4)


def _uvless_obj(tmp_path, name="nouv"):
    v, f, _, _ = torus(n_major=16, n_minor=8)
    path = tmp_path / f"{name}.obj"
    write_obj(path, v, f)
    return path


def _port_model(path, cache, **kw):
    return tm.TexturedMeshModel(GuideConfig(shape_path=str(path)),
                                render_grid_size=32, texture_resolution=16,
                                cache_path=cache, device="cpu", **kw)


def _reference_model(path, cache):
    return jtm.TexturedMeshModel(JGuideConfig(shape_path=str(path)),
                                 render_grid_size=32, texture_resolution=16,
                                 cache_path=cache, backend="xla")


def _no_unwrap(*a, **k):
    raise AssertionError("unwrapped although the atlas is cached")


def test_atlas_cache_is_written_then_read_by_either_package(
        tmp_path, monkeypatch):
    if objio.chart_unwrap_native(*torus(n_major=4, n_minor=3)[:2]) is None:
        pytest.skip("the JAX package's C++ unwrap does not build here")
    path = _uvless_obj(tmp_path)
    port_cache, ref_cache = tmp_path / "port_cache", tmp_path / "ref_cache"
    mm = _port_model(path, port_cache)
    ref = _reference_model(path, ref_cache)
    # the same file names (the geometry's tag) and the same atlas
    names = sorted(p.name for p in port_cache.iterdir())
    assert names == sorted(p.name for p in ref_cache.iterdir())
    assert len(names) == 2 and names[0].startswith("ft_")
    np.testing.assert_array_equal(mm.vt, ref.vt)
    np.testing.assert_array_equal(mm.ft, ref.ft)
    for name in names:
        a, b = np.load(port_cache / name), np.load(ref_cache / name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # a second build reads the cache and unwraps nothing, in both packages
    monkeypatch.setattr(tm, "atlas_unwrap", _no_unwrap)
    monkeypatch.setattr(jtm, "atlas_unwrap", _no_unwrap)
    again = _port_model(path, ref_cache)  # the reference's cache
    np.testing.assert_array_equal(again.vt, mm.vt)
    np.testing.assert_array_equal(again.ft, mm.ft)
    ref_again = _reference_model(path, port_cache)  # the port's cache
    np.testing.assert_array_equal(ref_again.vt, mm.vt)
    # the tag follows the normalised geometry: another scale, another file
    monkeypatch.undo()
    scaled = tm.TexturedMeshModel(
        GuideConfig(shape_path=str(path), shape_scale=0.5),
        render_grid_size=32, texture_resolution=16, cache_path=port_cache,
        device="cpu")
    assert len(list(port_cache.iterdir())) == 4
    assert scaled.vt.shape == mm.vt.shape


def test_uv_sources_in_the_reference_order(tmp_path, monkeypatch):
    """Mesh UVs first (a cache is neither read nor written), then the
    cache, then the unwrap; without a cache_path nothing is written."""
    v, f, vt, ft = uv_sphere(4, 6)
    write_obj(tmp_path / "uv.obj", v, f, vt, ft)
    cache = tmp_path / "cache"
    monkeypatch.setattr(tm, "atlas_unwrap", _no_unwrap)
    mm = _port_model(tmp_path / "uv.obj", cache)
    assert not cache.exists()
    np.testing.assert_array_equal(mm.vt, mm.mesh.vt)
    np.testing.assert_array_equal(mm.ft, mm.mesh.ft)
    monkeypatch.undo()

    path = _uvless_obj(tmp_path)
    calls = []
    real = tm.atlas_unwrap
    monkeypatch.setattr(tm, "atlas_unwrap",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _port_model(path, None)
    _port_model(path, None)
    assert len(calls) == 2  # no cache_path: unwrapped each time
    first = _port_model(path, cache)
    # a planted atlas in the cache wins over the unwrap
    for p in cache.iterdir():
        if p.name.startswith("vt_"):
            np.save(p, np.full_like(np.load(p), 0.25))
    second = _port_model(path, cache)
    assert len(calls) == 3
    assert np.all(second.vt == 0.25)
    np.testing.assert_array_equal(second.ft, first.ft)


def test_cli_paints_a_mesh_without_uvs_then_reads_its_cache(
        tmp_path, monkeypatch):
    """spot_quick_test.yaml on a mesh without vt lines: the CLI paints it
    with the reference's atlas (both packages' C++ unwrap), written to
    cache/<stem>/ under the reference's tag; a second run reads that file
    and does not unwrap."""
    from contexture_nerf_tpu.models.mesh import Mesh as JMesh

    path = _uvless_obj(tmp_path, "bring_your_own")
    monkeypatch.chdir(tmp_path)
    yaml = ROOT / "configs" / "text_guided" / "spot_quick_test.yaml"
    argv = [f"--config_path={yaml}",
            f"--guide.shape_path={path}", f"--log.exp_root={tmp_path}",
            "--render.train_grid_size=48", "--render.eval_grid_size=48",
            "--guide.texture_resolution=16", "--log.full_eval_size=1",
            "--optim.sds_iterations=1", "--log.log_images=false"]
    run = run_contexture.main(argv, device="cpu", tiny_models=True)
    assert (run.exp_path / "metrics.json").exists()
    assert (run.exp_path / "mesh" / "mesh.obj").exists()
    jm = JMesh.load(str(path)).normalize_mesh(
        target_scale=run.cfg.guide.shape_scale, dy=run.cfg.guide.dy)
    vt, ft = jtm.atlas_unwrap(jm.vertices, jm.faces)
    np.testing.assert_array_equal(run.mesh_model.vt, vt)
    np.testing.assert_array_equal(run.mesh_model.ft, ft)
    files = tm.atlas_cache_files(tmp_path / "cache" / "bring_your_own", jm)
    assert all(p.exists() for p in files)
    np.testing.assert_array_equal(np.load(files[0]), vt)

    monkeypatch.setattr(tm, "atlas_unwrap", _no_unwrap)
    again = run_contexture.main(argv + ["--log.eval_only=true"],
                                device="cpu", tiny_models=True)
    np.testing.assert_array_equal(again.mesh_model.vt, vt)
