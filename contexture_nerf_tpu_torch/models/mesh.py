"""Host-side OBJ/OFF loading and mesh normalization; the port's own copy of
contexture_nerf_tpu/models/mesh.py (`load_obj`'s numpy parser, `load_off`,
`calculate_face_normals`, `Mesh.load`, `normalize_mesh`,
`standardize_mesh`).

Mesh IO runs once at setup on the host; the renderer then moves the
vertices, faces and UVs to the device. `load_obj` reads with the C++ parser
(native/objio.py, built at first use), as the reference does where its
library builds; the numpy parser is its plain version (`native=False`), and
takes over when the C++ parser returns a nonzero code, as in the reference.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _triangulate_fan(idx_list):
    """Fan-triangulate an n-gon (naive homogenization)."""
    return [(idx_list[0], idx_list[k], idx_list[k + 1])
            for k in range(1, len(idx_list) - 1)]


def load_obj(path: str, native: bool = True
             ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                        Optional[np.ndarray]]:
    """Parse an OBJ file. Returns (vertices [N,3] f32, faces [F,3] i64,
    uvs [T,2] f32 or None, face_uvs_idx [F,3] i64 or None); polygons are
    fan-triangulated, negative indices count from the end. With `native`
    the C++ parser reads it (a build failure raises); the numpy parser
    below when it returns a nonzero code or native=False."""
    if native:
        from contexture_nerf_tpu_torch.native import objio

        parsed = objio.load_obj(path)
        if parsed is not None:
            return parsed
    verts, uvs = [], []
    face_v, face_vt = [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("f "):
                vi, ti = [], []
                for tok in line.split()[1:]:
                    comps = tok.split("/")
                    v = int(comps[0])
                    vi.append(v - 1 if v > 0 else len(verts) + v)
                    if len(comps) > 1 and comps[1] != "":
                        t = int(comps[1])
                        ti.append(t - 1 if t > 0 else len(uvs) + t)
                    else:
                        ti.append(-1)
                for tri in _triangulate_fan(list(range(len(vi)))):
                    face_v.append(tuple(vi[k] for k in tri))
                    face_vt.append(tuple(ti[k] for k in tri))
    vertices = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(face_v, dtype=np.int64)
    uvs_arr = np.asarray(uvs, dtype=np.float32) if uvs else None
    ft = np.asarray(face_vt, dtype=np.int64) if uvs else None
    return vertices, faces, uvs_arr, ft


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray, None, None]:
    """Parse an OFF file. Returns (vertices [N,3] f32, faces [F,3] i64,
    None, None); each polygon is fan-triangulated in file order."""
    with open(path, "r") as fh:
        tokens = fh.read().split()
    assert tokens[0] == "OFF", f"not an OFF file: {path}"
    nv, nf = int(tokens[1]), int(tokens[2])
    ptr = 4
    verts = np.asarray(tokens[ptr: ptr + 3 * nv],
                       dtype=np.float32).reshape(nv, 3)
    ptr += 3 * nv
    faces = []
    for _ in range(nf):
        n = int(tokens[ptr])
        faces.extend(_triangulate_fan(
            [int(t) for t in tokens[ptr + 1: ptr + 1 + n]]))
        ptr += 1 + n
    return verts, np.asarray(faces, dtype=np.int64), None, None


def calculate_face_normals(vertices: np.ndarray, faces: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face unit normals and areas from the cross product."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    twice_area = np.linalg.norm(n, axis=-1)
    n = n / np.where(twice_area[:, None] == 0, 1.0, twice_area[:, None])
    return n.astype(np.float32), (twice_area / 2).astype(np.float32)


@dataclass
class Mesh:
    """vertices [N,3] f32, faces [F,3] i64, vt [T,2] f32 UVs or None,
    ft [F,3] i64 face -> UV indices or None."""

    vertices: np.ndarray
    faces: np.ndarray
    vt: Optional[np.ndarray]
    ft: Optional[np.ndarray]
    normals: np.ndarray = None
    face_area: np.ndarray = None

    @classmethod
    def load(cls, obj_path: str, native: bool = True) -> "Mesh":
        """Read an OBJ (through the C++ parser with `native`) or an OFF."""
        if ".obj" in str(obj_path):
            vertices, faces, vt, ft = load_obj(str(obj_path), native)
        elif ".off" in str(obj_path):
            vertices, faces, vt, ft = load_off(str(obj_path))
        else:
            raise ValueError(
                f"{obj_path} extension not implemented in mesh reader.")
        normals, face_area = calculate_face_normals(vertices, faces)
        return cls(vertices=vertices, faces=faces, vt=vt, ft=ft,
                   normals=normals, face_area=face_area)

    def normalize_mesh(self, inplace: bool = False, target_scale: float = 1.0,
                       dy: float = 0.0) -> "Mesh":
        """Center, scale into the unit sphere times target_scale, shift y
        by dy."""
        mesh = self if inplace else copy.deepcopy(self)
        verts = mesh.vertices.astype(np.float32)
        verts = verts - verts.mean(axis=0)
        scale = np.linalg.norm(verts, axis=1).max()
        verts = verts / scale * target_scale
        verts[:, 1] += dy
        mesh.vertices = verts
        mesh.normals, mesh.face_area = calculate_face_normals(
            mesh.vertices, mesh.faces)
        return mesh

    def standardize_mesh(self, inplace: bool = False) -> "Mesh":
        """Center and scale by the std of the vertex norms."""
        mesh = self if inplace else copy.deepcopy(self)
        verts = mesh.vertices.astype(np.float32)
        verts = verts - verts.mean(axis=0)
        verts = verts / np.linalg.norm(verts, axis=1).std()
        mesh.vertices = verts
        return mesh
