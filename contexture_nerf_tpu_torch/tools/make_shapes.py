"""Procedural mesh assets (UV sphere, env sphere, torus, box, the
stand-ins of the configs' meshes); the port's own copy of
tools/make_shapes.py (`uv_sphere`, `torus`, `ellipsoid`, `box`, `merge`,
`STANDINS`, `ensure_shape`, `write_obj`).

    python -m contexture_nerf_tpu_torch.tools.make_shapes

writes sphere.obj, env_sphere.obj and torus.obj into shapes/.
"""

from pathlib import Path

import numpy as np


def uv_sphere(n_lat=32, n_lon=64, radius=1.0, invert=False):
    """UV sphere with per-vertex UVs. Returns (verts, faces, vt, ft)."""
    verts, uvs = [], []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            verts.append((radius * np.sin(theta) * np.cos(phi),
                          radius * np.cos(theta),
                          radius * np.sin(theta) * np.sin(phi)))
            uvs.append((j / n_lon, 1 - i / n_lat))
    verts = np.asarray(verts, np.float32)
    uvs = np.asarray(uvs, np.float32)
    faces = []
    W = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            if i > 0:
                faces.append((a, c, b) if not invert else (a, b, c))
            if i < n_lat - 1:
                faces.append((b, c, d) if not invert else (b, d, c))
    return verts, np.asarray(faces, np.int64), uvs, np.asarray(faces, np.int64)


def torus(R=0.7, r=0.3, n_major=48, n_minor=24):
    verts, uvs = [], []
    for i in range(n_major + 1):
        u = 2 * np.pi * i / n_major
        for j in range(n_minor + 1):
            v = 2 * np.pi * j / n_minor
            verts.append((((R + r * np.cos(v)) * np.cos(u)),
                          r * np.sin(v),
                          ((R + r * np.cos(v)) * np.sin(u))))
            uvs.append((i / n_major, j / n_minor))
    verts = np.asarray(verts, np.float32)
    uvs = np.asarray(uvs, np.float32)
    faces = []
    W = n_minor + 1
    for i in range(n_major):
        for j in range(n_minor):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            faces.append((a, c, b))
            faces.append((b, c, d))
    return verts, np.asarray(faces, np.int64), uvs, np.asarray(faces, np.int64)


def ellipsoid(scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
              n_lat=16, n_lon=24):
    v, f, vt, ft = uv_sphere(n_lat, n_lon)
    v = v * np.asarray(scale, np.float32) + np.asarray(offset, np.float32)
    return v, f, vt, ft


def box(size=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0)):
    """Axis-aligned box with per-face-quad UVs."""
    sx, sy, sz = np.asarray(size, np.float32) / 2
    ox, oy, oz = offset
    corners = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                        for z in (-sz, sz)], np.float32)
    corners += np.asarray([ox, oy, oz], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    verts, uvs, faces = [], [], []
    uv_quad = [(0.05, 0.05), (0.95, 0.05), (0.95, 0.95), (0.05, 0.95)]
    for q in quads:
        base = len(verts)
        for k, vi in enumerate(q):
            verts.append(corners[vi])
            uvs.append(uv_quad[k])
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    faces = np.asarray(faces, np.int64)
    return (np.asarray(verts, np.float32), faces,
            np.asarray(uvs, np.float32), faces.copy())


def merge(*meshes):
    """Concatenate (verts, faces, vt, ft) meshes with index offsetting."""
    verts, faces, vts, fts = [], [], [], []
    vo = to = 0
    for v, f, vt, ft in meshes:
        verts.append(v)
        faces.append(f + vo)
        vts.append(vt)
        fts.append(ft + to)
        vo += v.shape[0]
        to += vt.shape[0]
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(vts), np.concatenate(fts))


# Procedural stand-ins for the meshes the shipped configs name (spot, bunny,
# nascar, human, ...), which the repository does not carry: schematic
# geometry; a real .obj in shapes/ takes their place.
STANDINS = {
    "sphere": lambda: uv_sphere(24, 48),
    "env_sphere": lambda: uv_sphere(16, 32, radius=10.0, invert=True),
    "torus": lambda: torus(),
    # dairy-cow stand-in: stretched body + head + 4 leg boxes
    "spot_triangulated": lambda: merge(
        ellipsoid((1.0, 0.55, 0.45)),
        ellipsoid((0.32, 0.28, 0.25), (0.95, 0.35, 0.0), n_lat=10, n_lon=14),
        *[box((0.14, 0.7, 0.14), (x, -0.6, z))
          for x in (-0.55, 0.55) for z in (-0.22, 0.22)]),
    "spot": lambda: STANDINS["spot_triangulated"](),
    # bust stand-in: torso + head + hat brim
    "napoleon": lambda: merge(
        ellipsoid((0.55, 0.7, 0.4), (0.0, -0.5, 0.0)),
        ellipsoid((0.3, 0.38, 0.3), (0.0, 0.35, 0.0)),
        box((0.75, 0.1, 0.45), (0.0, 0.72, 0.0))),
    # stock-car stand-in: chassis + cabin + 4 wheels
    "nascar": lambda: merge(
        box((2.0, 0.4, 0.9)),
        box((1.0, 0.35, 0.8), (-0.1, 0.37, 0.0)),
        *[ellipsoid((0.22, 0.22, 0.1), (x, -0.25, z), n_lat=8, n_lon=12)
          for x in (-0.65, 0.65) for z in (-0.48, 0.48)]),
    # rabbit stand-in: body + head + two ears
    "bunny": lambda: merge(
        ellipsoid((0.55, 0.45, 0.5)),
        ellipsoid((0.3, 0.3, 0.3), (0.35, 0.45, 0.0), n_lat=10, n_lon=14),
        ellipsoid((0.07, 0.35, 0.1), (0.25, 0.95, -0.12), n_lat=6, n_lon=8),
        ellipsoid((0.07, 0.35, 0.1), (0.25, 0.95, 0.12), n_lat=6, n_lon=8)),
    # humanoid stand-in: torso + head + limbs
    "human": lambda: merge(
        ellipsoid((0.35, 0.6, 0.22)),
        ellipsoid((0.18, 0.22, 0.18), (0.0, 0.85, 0.0), n_lat=10, n_lon=14),
        *[box((0.12, 0.75, 0.12), (x, -1.0, 0.0)) for x in (-0.18, 0.18)],
        *[box((0.1, 0.6, 0.1), (x, 0.2, 0.0)) for x in (-0.48, 0.48)]),
    # person (texfusion_dataset/Text2Mesh/person.obj, astronaut.yaml): same
    # schematic humanoid
    "person": lambda: STANDINS["human"](),
    # cartoon-mouse stand-in: round body + head + two disc ears
    "mickey": lambda: merge(
        ellipsoid((0.45, 0.55, 0.4), (0.0, -0.4, 0.0)),
        ellipsoid((0.35, 0.35, 0.35), (0.0, 0.35, 0.0), n_lat=12, n_lon=16),
        ellipsoid((0.2, 0.2, 0.06), (-0.32, 0.75, 0.0), n_lat=8, n_lon=10),
        ellipsoid((0.2, 0.2, 0.06), (0.32, 0.75, 0.0), n_lat=8, n_lon=10)),
    # rectangular-sponge stand-in: body box + two legs + two arms
    "spongebob": lambda: merge(
        box((0.9, 1.1, 0.45)),
        *[box((0.1, 0.5, 0.1), (x, -0.95, 0.0)) for x in (-0.25, 0.25)],
        *[box((0.4, 0.1, 0.1), (x, 0.0, 0.0)) for x in (-0.62, 0.62)]),
}


def ensure_shape(path) -> bool:
    """Generate a procedural stand-in for a known shape name if the file is
    missing (keeps the shipped configs/text_guided/*.yaml runnable without
    binary assets). Returns True if the file exists afterwards."""
    p = Path(path)
    if p.exists():
        return True
    maker = STANDINS.get(p.stem)
    if maker is None:
        return False
    p.parent.mkdir(parents=True, exist_ok=True)
    write_obj(p, *maker())
    print(f"generated procedural stand-in mesh {p}")
    return True


def write_obj(path, verts, faces, vt=None, ft=None):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if vt is not None:
            for t in vt:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for i, face in enumerate(faces):
            if ft is not None:
                f.write("f " + " ".join(f"{face[k]+1}/{ft[i][k]+1}"
                                        for k in range(3)) + "\n")
            else:
                f.write("f " + " ".join(str(face[k] + 1)
                                        for k in range(3)) + "\n")


def main(out_dir="shapes"):
    out = Path(out_dir)
    out.mkdir(exist_ok=True)
    write_obj(out / "sphere.obj", *uv_sphere(24, 48))
    write_obj(out / "env_sphere.obj", *uv_sphere(16, 32, radius=10.0,
                                                 invert=True))
    write_obj(out / "torus.obj", *torus())
    print(f"wrote sphere.obj, env_sphere.obj, torus.obj to {out}/")


if __name__ == "__main__":
    main()
