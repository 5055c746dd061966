"""The port's native OBJ reader and chart unwrap
(contexture_nerf_tpu_torch.native.objio, built from its own copy of
csrc/objio.cpp) against the JAX package's (contexture_nerf_tpu.native
.objio): the same source, flags and inputs give the same arrays bit for
bit, on a torus, a small UV sphere and the spiral ramp of
tests/test_torch_atlas.py. `load_obj` and `atlas_unwrap` take the C++
path where the reference does; a chart that overlaps itself sends both
packages to the numpy path; an atlas cache written by one package is read
unchanged by the other; a failed build raises with its cause.
"""

from pathlib import Path

import numpy as np
import pytest

from contexture_nerf_tpu.core.config import GuideConfig as JGuideConfig
from contexture_nerf_tpu.models import mesh as jmesh
from contexture_nerf_tpu.models import textured_mesh as jtm
from contexture_nerf_tpu.native import objio as jobjio
from contexture_nerf_tpu_torch.core.config import GuideConfig
from contexture_nerf_tpu_torch.models import mesh as tmesh
from contexture_nerf_tpu_torch.models import textured_mesh as tm
from contexture_nerf_tpu_torch.native import objio
from tools.make_shapes import torus, uv_sphere, write_obj


def _spiral_ramp(turns=2.0, segs=48):
    """tests/test_torch_atlas.py's ramp: every normal inside a 75-degree
    cone, yet the turns overlap in the seed plane."""
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


SHAPES = {
    "torus": lambda: torus(n_major=24, n_minor=12)[:2],
    "uv_sphere": lambda: uv_sphere(8, 12)[:2],
    "spiral_ramp": _spiral_ramp,
}


@pytest.fixture(scope="module", autouse=True)
def reference_builds():
    v, f = SHAPES["torus"]()
    if jobjio.chart_unwrap_native(v, f) is None:
        pytest.skip("the JAX package's C++ library does not build here")


@pytest.mark.parametrize("uvs", [True, False])
@pytest.mark.parametrize("shape", ["torus", "uv_sphere"])
def test_load_obj_equals_the_reference_native_reader(tmp_path, shape, uvs):
    maker = torus if shape == "torus" else uv_sphere
    args = {"torus": (16, 8), "uv_sphere": (8, 12)}[shape]
    v, f, vt, ft = maker(*args)
    path = tmp_path / f"{shape}.obj"
    write_obj(path, v, f, vt if uvs else None, ft if uvs else None)
    got, ref = objio.load_obj(str(path)), jobjio.load_obj(str(path))
    assert got is not None and ref is not None
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the entry points: the port's load_obj and Mesh.load take that path
    for a, b in zip(tmesh.load_obj(str(path)), jmesh.load_obj(str(path))):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    plain = tmesh.load_obj(str(path), native=False)
    np.testing.assert_array_equal(plain[0], got[0])
    np.testing.assert_array_equal(plain[1], got[1])
    assert (plain[2] is None) == (not uvs)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_chart_unwrap_equals_the_reference_native_unwrap(shape):
    v, f = SHAPES[shape]()
    vt, ft = objio.chart_unwrap_native(v, f)
    vt_r, ft_r = jobjio.chart_unwrap_native(v, f)
    assert vt.dtype == vt_r.dtype == np.float32
    assert ft.dtype == ft_r.dtype == np.int64
    np.testing.assert_array_equal(vt, vt_r)
    np.testing.assert_array_equal(ft, ft_r)
    # atlas_unwrap in both packages: the C++ atlas unless a chart overlaps
    got, ref = tm.atlas_unwrap(v, f), jtm.atlas_unwrap(v, f)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    takes_native = not tm._chart_overlaps(vt, ft)
    assert takes_native == (shape != "spiral_ramp")
    if takes_native:
        np.testing.assert_array_equal(got[0], vt)


def test_overlapping_chart_takes_the_numpy_path_in_both_packages():
    v, f = _spiral_ramp()
    native = objio.chart_unwrap_native(v, f)
    assert tm._chart_overlaps(*native) and jtm._chart_overlaps(*native)
    plain = tm.atlas_unwrap(v, f, native=False)
    for got in (tm.atlas_unwrap(v, f), jtm.atlas_unwrap(v, f)):
        np.testing.assert_array_equal(got[0], plain[0])
        np.testing.assert_array_equal(got[1], plain[1])
    assert tm._overlap_frac(plain[0], plain[1], G=256) < 0.02


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_atlas_cache_written_by_one_package_is_read_by_the_other(
        tmp_path, monkeypatch, writer):
    v, f, _, _ = uv_sphere(8, 12)
    path = tmp_path / "nouv.obj"
    write_obj(path, v, f)
    cache = tmp_path / "cache"
    port = lambda: tm.TexturedMeshModel(  # noqa: E731
        GuideConfig(shape_path=str(path)), render_grid_size=32,
        texture_resolution=16, cache_path=cache, device="cpu")
    ref = lambda: jtm.TexturedMeshModel(  # noqa: E731
        JGuideConfig(shape_path=str(path)), render_grid_size=32,
        texture_resolution=16, cache_path=cache, backend="xla")
    first, second = (port, ref) if writer == "port" else (ref, port)
    made = first()
    files = sorted(cache.iterdir())
    stamps = [p.stat().st_mtime_ns for p in files]
    written = [np.load(p) for p in files]

    def no_unwrap(*a, **k):
        raise AssertionError("unwrapped although the atlas is cached")

    monkeypatch.setattr(tm, "atlas_unwrap", no_unwrap)
    monkeypatch.setattr(jtm, "atlas_unwrap", no_unwrap)
    read = second()
    np.testing.assert_array_equal(np.asarray(read.vt), np.asarray(made.vt))
    np.testing.assert_array_equal(np.asarray(read.ft), np.asarray(made.ft))
    assert sorted(cache.iterdir()) == files
    assert [p.stat().st_mtime_ns for p in files] == stamps
    for p, a in zip(files, written):
        np.testing.assert_array_equal(np.load(p), a)


def test_a_failed_build_raises_with_its_cause(tmp_path, monkeypatch):
    """No silent numpy fallback: without g++, or with a source g++ refuses,
    the native entry points raise, and native=False still works."""
    v, f = SHAPES["torus"]()
    monkeypatch.setattr(objio, "_LIB", None)
    monkeypatch.setattr(objio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(objio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        tm.atlas_unwrap(v, f)
    monkeypatch.undo()
    bad = tmp_path / "objio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(objio, "_LIB", None)
    monkeypatch.setattr(objio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(objio, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g.. failed"):
        objio.load_obj(str(Path(__file__)))
    vt, ft = tm.atlas_unwrap(v, f, native=False)
    assert ft.shape == f.shape
