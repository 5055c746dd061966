"""OFF meshes in the port (contexture_nerf_tpu_torch.models.mesh `load_off`,
`Mesh.load`'s dispatch, `Mesh.standardize_mesh`) against the JAX
package's, on files written here from a seeded numpy generator; then an
OFF shape (no UVs) through `build_models` against the JAX mesh model, and
through the port's CLI against the same mesh written as an OBJ.

Tolerance: none. Both packages parse the same tokens with the same numpy
calls and fan-triangulate in the same order, so arrays are equal exactly,
and the atlas unwrapped from them is equal bit for bit. The two CLI runs
start from the same seed on equal arrays and atlases on the CPU, so their
losses, parameters and exported albedo are equal bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import GuideConfig as JGuideConfig
from contexture_nerf_tpu.models import mesh as jmesh
from contexture_nerf_tpu.models import textured_mesh as jtm
from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.models import mesh as tmesh
from contexture_nerf_tpu_torch.training import trainer as tr
from tools.make_shapes import uv_sphere, write_obj

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_off(path, verts, polys):
    """An OFF file: the header, the vertices as %.6f, then each polygon as
    its size and its vertex indices."""
    with open(path, "w") as fh:
        fh.write(f"OFF\n{len(verts)} {len(polys)} 0\n")
        for v in verts:
            fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for p in polys:
            fh.write(f"{len(p)} " + " ".join(str(int(i)) for i in p) + "\n")


def _polys(kind, rng, nv=40, nf=30):
    sizes = {"triangles": [3], "quads": [4], "pentagons": [5],
             "mixed": [3, 4, 5, 6]}[kind]
    return [rng.choice(nv, size=int(rng.choice(sizes)), replace=False)
            for _ in range(nf)]


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["triangles", "quads", "pentagons", "mixed"])
def test_load_off_equals_the_reference(tmp_path, kind):
    rng = np.random.default_rng(["triangles", "quads", "pentagons",
                                 "mixed"].index(kind))
    verts = rng.standard_normal((40, 3)).astype(np.float32)
    polys = _polys(kind, rng)
    path = tmp_path / f"{kind}.off"
    write_off(path, verts, polys)
    got, ref = tmesh.load_off(str(path)), jmesh.load_off(str(path))
    _assert_same(got, ref)
    v, f, vt, ft = got
    assert v.dtype == np.float32 and f.dtype == np.int64
    assert vt is None and ft is None
    assert f.shape == (sum(len(p) - 2 for p in polys), 3)
    # the fan of each polygon, in file order
    first = polys[0]
    np.testing.assert_array_equal(
        f[:len(first) - 2],
        [[first[0], first[k], first[k + 1]] for k in range(1, len(first) - 1)])


@pytest.mark.parametrize("ext", [".obj", ".off", ".ply"])
def test_mesh_load_dispatches_as_the_reference(tmp_path, ext):
    rng = np.random.default_rng(7)
    v, f, _, _ = uv_sphere(6, 8)
    v = v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
    path = tmp_path / f"shape{ext}"
    if ext == ".obj":
        write_obj(path, v, f)
    else:
        write_off(path, v, f)  # a .ply holding OFF text: the name decides
    if ext == ".ply":
        with pytest.raises(ValueError) as got:
            tmesh.Mesh.load(str(path))
        with pytest.raises(ValueError) as ref:
            jmesh.Mesh.load(str(path))
        assert str(got.value) == str(ref.value) == \
            f"{path} extension not implemented in mesh reader."
        return
    got, ref = tmesh.Mesh.load(str(path)), jmesh.Mesh.load(str(path))
    _assert_same([got.vertices, got.faces, got.vt, got.ft, got.normals,
                  got.face_area],
                 [ref.vertices, ref.faces, ref.vt, ref.ft, ref.normals,
                  ref.face_area])


def test_obj_and_off_of_one_mesh_load_equal(tmp_path):
    v, f, _, _ = uv_sphere(8, 12)
    write_obj(tmp_path / "s.obj", v, f)
    write_off(tmp_path / "s.off", v, f)
    a = tmesh.Mesh.load(str(tmp_path / "s.obj"))
    b = tmesh.Mesh.load(str(tmp_path / "s.off"))
    _assert_same([b.vertices, b.faces, b.normals, b.face_area],
                 [a.vertices, a.faces, a.normals, a.face_area])
    assert a.vt is None and b.vt is None


@pytest.mark.parametrize("inplace", [False, True])
def test_standardize_mesh_equals_the_reference(tmp_path, inplace):
    rng = np.random.default_rng(3)
    verts = (rng.standard_normal((30, 3)) * [1.0, 2.0, 0.5] + [3, -1, 2]
             ).astype(np.float32)
    path = tmp_path / "s.off"
    write_off(path, verts, _polys("mixed", rng, nv=30, nf=20))
    got_m, ref_m = tmesh.Mesh.load(str(path)), jmesh.Mesh.load(str(path))
    before = got_m.vertices.copy()
    got = got_m.standardize_mesh(inplace=inplace)
    ref = ref_m.standardize_mesh(inplace=inplace)
    assert (got is got_m) == inplace
    if not inplace:
        np.testing.assert_array_equal(got_m.vertices, before)
    assert got.vertices.dtype == np.float32
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices.mean(axis=0), 0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.vertices, axis=1).std(), 1,
                               rtol=1e-5)


def _cfg(tmp, shape, exp_name="off"):
    return config_from_dict({
        "log": {"exp_name": exp_name, "exp_root": str(tmp / "exp")},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "a tiny test prompt", "shape_path": str(shape),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": 1}})


def test_an_off_shape_unwraps_through_build_models_as_the_reference(
        tmp_path, monkeypatch):
    """No UVs in an OFF: build_models unwraps it with atlas_unwrap into
    cache/<stem>/ under the working directory, and the JAX mesh model
    reads the same file to the same atlas bit for bit."""
    monkeypatch.chdir(tmp_path)
    v, f, _, _ = uv_sphere(8, 12)
    write_off(tmp_path / "ball.off", v, f)
    cfg = _cfg(tmp_path, tmp_path / "ball.off")
    *_, mesh_model = tr.build_models(cfg, tiny=True, device="cpu",
                                     skip_bootstrap=True)
    cached = sorted(p.name for p in (tmp_path / "cache" / "ball").iterdir())
    assert [n[:3] for n in cached] == ["ft_", "vt_"]
    ref = jtm.TexturedMeshModel(
        JGuideConfig(shape_path=str(tmp_path / "ball.off")),
        render_grid_size=32, texture_resolution=16,
        cache_path=tmp_path / "ref_cache", backend="xla")
    assert mesh_model.vt.dtype == np.float32
    np.testing.assert_array_equal(mesh_model.vt, np.asarray(ref.vt))
    np.testing.assert_array_equal(mesh_model.ft, np.asarray(ref.ft))
    np.testing.assert_array_equal(mesh_model.mesh.vertices,
                                  np.asarray(ref.mesh.vertices))
    # the reference cached the same atlas under the same names
    assert sorted(p.name for p in (tmp_path / "ref_cache").iterdir()) == \
        cached


def test_the_cli_paints_an_off_as_the_same_mesh_as_an_obj(tmp_path,
                                                          monkeypatch):
    """guide.shape_path=<x>.off paints through the port's CLI, each shape
    under its own stem and atlas cache, and gives the OBJ's run bit for
    bit."""
    monkeypatch.chdir(tmp_path)
    v, f, _, _ = uv_sphere(8, 12)
    write_obj(tmp_path / "ball_obj.obj", v, f)
    write_off(tmp_path / "ball_off.off", v, f)
    runs = {}
    for ext in ("obj", "off"):
        argv = [f"--config_path={ROOT / 'configs/text_guided/spot_quick_test.yaml'}",
                f"--log.exp_root={tmp_path / 'exp'}",
                f"--log.exp_name=run_{ext}",
                f"--guide.shape_path={tmp_path / f'ball_{ext}.{ext}'}",
                "--render.train_grid_size=32", "--render.eval_grid_size=32",
                "--guide.texture_resolution=16", "--log.full_eval_size=2",
                "--optim.sds_iterations=1"]
        runs[ext] = run_contexture.main(argv, device="cpu", tiny_models=True)
    a, b = runs["obj"], runs["off"]
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == \
        ["ball_obj", "ball_off"]
    np.testing.assert_array_equal(a.mesh_model.vt, b.mesh_model.vt)
    np.testing.assert_array_equal(a.mesh_model.ft, b.mesh_model.ft)
    for k, p in a.mlp.state_dict().items():
        assert torch.equal(p, b.mlp.state_dict()[k]), k
    exp = tmp_path / "exp"
    ma = json.loads((exp / "run_obj" / "metrics.json").read_text())
    mb = json.loads((exp / "run_off" / "metrics.json").read_text())
    losses = [[m["sds_loss"] for m in mx if "sds_loss" in m]
              for mx in (ma, mb)]
    assert losses[0] and losses[0] == losses[1]
    for name in ("mesh/albedo.png", "results/eval_texture_atlas.png"):
        assert (exp / "run_obj" / name).read_bytes() == \
            (exp / "run_off" / name).read_bytes(), name
