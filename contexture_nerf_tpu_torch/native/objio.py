"""ctypes binding of the C++ OBJ reader and chart unwrap (csrc/objio.cpp,
the port's copy of contexture_nerf_tpu/native/objio.cpp); counterpart of
contexture_nerf_tpu/native/objio.py.

The library is built at first use with the reference's command, `g++ -O2
-shared -fPIC`, into build/native/ at the root of the checkout; the file
name carries a hash of the source and flags. Nothing is built at import.
Unlike the reference, which returns None and lets its callers take the
numpy path when g++ is missing or the build fails, a failed build or a
library without the expected symbols raises here with g++'s log: the numpy
paths are reached only by asking for them (`native=False`). A nonzero code
from the C++ parser or unwrap still returns None, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "objio.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("n_vertices", ctypes.c_int64),
        ("faces", ctypes.POINTER(ctypes.c_int64)),
        ("n_faces", ctypes.c_int64),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("n_uvs", ctypes.c_int64),
        ("face_uvs", ctypes.POINTER(ctypes.c_int64)),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libobjio-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library's path, compiling it first when it is missing;
    raises with g++'s output when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native OBJ reader and "
                           "unwrap (csrc/objio.cpp) cannot be built; pass "
                           "native=False for the numpy paths")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                           f"(exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders each write their own
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = build()
        try:
            lib = ctypes.CDLL(str(so))
            lib.objio_load.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(_ObjMesh)]
            lib.objio_load.restype = ctypes.c_int
            lib.objio_free.argtypes = [ctypes.POINTER(_ObjMesh)]
            lib.objio_chart_unwrap.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.objio_chart_unwrap.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"{so} does not load or lacks a symbol: "
                               f"{e}") from e
        _LIB = lib
        return lib


def load_obj(path: str):
    """C++ OBJ parse: (verts, faces, uvs or None, ft or None), or None when
    the parser returns a nonzero code (the caller then parses with numpy,
    as the reference does)."""
    lib = _lib()
    mesh = _ObjMesh()
    if lib.objio_load(str(path).encode(), ctypes.byref(mesh)) != 0:
        return None
    try:
        nv, nf, nt = mesh.n_vertices, mesh.n_faces, mesh.n_uvs
        verts = np.ctypeslib.as_array(mesh.vertices, (nv, 3)).copy()
        faces = np.ctypeslib.as_array(mesh.faces, (nf, 3)).copy()
        uvs = ft = None
        if nt > 0:
            uvs = np.ctypeslib.as_array(mesh.uvs, (nt, 2)).copy()
            ft = np.ctypeslib.as_array(mesh.face_uvs, (nf, 3)).copy()
            if ft.min() < 0:
                uvs, ft = None, None
        return verts, faces, uvs, ft
    finally:
        lib.objio_free(ctypes.byref(mesh))


def chart_unwrap_native(vertices: np.ndarray, faces: np.ndarray,
                        angle_thr_deg: float = 75.0,
                        gutter: float = 4.0 / 1024.0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """C++ connected-chart UV unwrap (the algorithm of
    models/textured_mesh.py `atlas_unwrap`: charts grown over face
    adjacency, planar projection with welded vertices, shelf packing).
    Returns (vt (n, 2) f32, ft (F, 3) i64), or None when the unwrap
    returns a nonzero code."""
    lib = _lib()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    F = faces.shape[0]
    vt = np.zeros((3 * F, 2), np.float32)
    ft = np.zeros((F, 3), np.int64)
    n_vt = np.zeros((1,), np.int64)
    rc = lib.objio_chart_unwrap(
        vertices.shape[0],
        vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        F, faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_float(angle_thr_deg), ctypes.c_float(gutter),
        vt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ft.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_vt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return vt[:int(n_vt[0])].copy(), ft
