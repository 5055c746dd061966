"""Textured mesh model: mesh + renderer + the texture MLP's lattice; the
port's counterpart of contexture_nerf_tpu/models/textured_mesh.py
`TexturedMeshModel` (`_init_texture_map`, `render_geometry`, `render`,
`get_texture_map`, `apply_median_fill`, `query_texture_at_uv`,
`get_texture_map_only_valid_areas`, `fit_texture_to_image`,
`render_face_normals_face_idx`, the augmentations `cotan_laplacian`,
`eigens`, `normalize_vertices`, `spectral_augmentations`,
`axis_augmentations`, `augment_vertices`, and `export_mesh`) and of its UV
atlas, `atlas_unwrap`.

As in the reference, the MLP's parameters are outside the model: every
texture call takes the NeRF2D module. A mesh without UVs is unwrapped once
on the host (`atlas_unwrap`: the C++ unwrap of native/objio.py, as the
reference takes where its library builds, or the numpy path) and the atlas
is cached on disk under the reference's file names, so a cache written by
either package serves the other.
"""

from __future__ import annotations

import hashlib
import math
import os
from collections import deque
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.models.fields import NeRF2D, texture_from_mlp
from contexture_nerf_tpu_torch.models.mesh import Mesh
from contexture_nerf_tpu_torch.ops.image import save_image
from contexture_nerf_tpu_torch.ops.mlp_kernel import fused_nerf2d
from contexture_nerf_tpu_torch.ops.texture import sample_texture
from contexture_nerf_tpu_torch.raster.raster_kernel import rasterize_geometry
from contexture_nerf_tpu_torch.raster.rasterize import interpolate_attributes
from contexture_nerf_tpu_torch.raster.render import RenderCache, Renderer


# -- the UV atlas of a mesh without UVs (host, numpy, once a mesh) ------------

def _face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    e1 = vertices[faces[:, 1]] - vertices[faces[:, 0]]
    e2 = vertices[faces[:, 2]] - vertices[faces[:, 0]]
    n = np.cross(e1, e2)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def _grow_charts(vertices: np.ndarray, faces: np.ndarray,
                 angle_thr_deg: float) -> np.ndarray:
    """Breadth-first chart growing over the face-adjacency graph: a
    neighbour joins a chart while its normal stays within angle_thr of the
    chart's seed normal. Returns the chart id of each face."""
    F = faces.shape[0]
    normals = _face_normals(vertices, faces)
    edge_to_faces: Dict[Tuple[int, int], list] = {}
    for f in range(F):
        a, b, c = faces[f]
        for e in ((a, b), (b, c), (c, a)):
            edge_to_faces.setdefault(tuple(sorted(e)), []).append(f)
    neighbors = [[] for _ in range(F)]
    for fs in edge_to_faces.values():
        for i in fs:
            for j in fs:
                if i != j:
                    neighbors[i].append(j)

    cos_thr = np.cos(np.deg2rad(angle_thr_deg))
    chart = np.full(F, -1, np.int64)
    n_charts = 0
    for seed in range(F):
        if chart[seed] >= 0:
            continue
        cid = n_charts
        n_charts += 1
        chart[seed] = cid
        seed_n = normals[seed]
        q = deque([seed])
        while q:
            f = q.popleft()
            for g in neighbors[f]:
                if chart[g] < 0 and float(normals[g] @ seed_n) >= cos_thr:
                    chart[g] = cid
                    q.append(g)
    return chart


def _per_face_unwrap(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The fallback packer: every triangle gets its own right-triangle cell
    in a ceil(sqrt(F))-column grid (no UV continuity; only used when the
    shelves cannot hold the charts)."""
    F = faces.shape[0]
    cols = int(np.ceil(np.sqrt(F)))
    rows = int(np.ceil(F / cols))
    cw, ch = 1.0 / cols, 1.0 / rows
    gut = 0.1
    vt = np.zeros((3 * F, 2), np.float32)
    ft = np.arange(3 * F, dtype=np.int64).reshape(F, 3)
    idx = np.arange(F)
    cx = (idx % cols) * cw
    cy = (idx // cols) * ch
    vt[0::3] = np.stack([cx + gut * cw, cy + gut * ch], -1)
    vt[1::3] = np.stack([cx + (1 - gut) * cw, cy + gut * ch], -1)
    vt[2::3] = np.stack([cx + gut * cw, cy + (1 - gut) * ch], -1)
    return vt, ft


def _coverage_count(uv: np.ndarray, ft: np.ndarray, G: int = 128
                    ) -> np.ndarray:
    """How many of the triangles `ft` over `uv` cover each texel centre of a
    G^2 grid spanning the box of the vertices `ft` uses. A centre counts
    only strictly inside a triangle, so shared edges do not count twice."""
    used = uv[np.unique(ft)]
    lo = used.min(axis=0)
    span = np.maximum(used.max(axis=0) - lo, 1e-12)
    uvn = (uv - lo) / span * G
    cover = np.zeros((G, G), np.int32)
    for tri in ft:
        p = uvn[tri]  # (3,2)
        x0, y0 = np.floor(p.min(axis=0)).astype(int)
        x1, y1 = np.ceil(p.max(axis=0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, G), min(y1, G)
        if x1 <= x0 or y1 <= y0:
            continue
        xs = np.arange(x0, x1) + 0.5
        ys = np.arange(y0, y1) + 0.5
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        d = np.stack([gx - p[0, 0], gy - p[0, 1]], axis=-1)
        e1 = p[1] - p[0]
        e2 = p[2] - p[0]
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        a = (d[..., 0] * e2[1] - d[..., 1] * e2[0]) / det
        b = (e1[0] * d[..., 1] - e1[1] * d[..., 0]) / det
        eps = 1e-6
        inside = (a > eps) & (b > eps) & (a + b < 1 - eps)
        cover[y0:y1, x0:x1] += inside.astype(np.int32)
    return cover


def _overlap_frac(uv: np.ndarray, ft: np.ndarray, G: int = 128) -> float:
    """The share of covered texels that two or more triangles cover."""
    cover = _coverage_count(uv, ft, G)
    covered = int((cover > 0).sum())
    return float((cover > 1).sum()) / max(covered, 1)


def _charts_from_ft(ft: np.ndarray) -> np.ndarray:
    """The chart of each face, by union-find over shared UV vertices (a
    welded chart shares them; two charts never do)."""
    n = int(ft.max()) + 1
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for tri in ft:
        r = find(tri[0])
        for b in tri[1:]:
            rb = find(b)
            if rb != r:
                parent[rb] = r
    roots = np.array([find(v) for v in ft[:, 0]])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def _chart_overlaps(vt: np.ndarray, ft: np.ndarray,
                    thr: float = 0.05) -> bool:
    """True if a welded chart of two or more faces overlaps itself in UV
    space by more than `thr` of its texels."""
    labels = _charts_from_ft(ft)
    for cid in range(labels.max() + 1):
        fids = np.nonzero(labels == cid)[0]
        if len(fids) < 2:
            continue
        if _overlap_frac(vt, ft[fids]) > thr:
            return True
    return False


def atlas_unwrap(vertices: np.ndarray, faces: np.ndarray,
                 angle_thr_deg: float = 75.0,
                 gutter: float = 4.0 / 1024.0, native: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Connected-chart UV unwrap. With `native`, the C++ unwrap
    (native/objio.py `chart_unwrap_native`; a build failure raises) gives
    the atlas unless one of its charts overlaps itself (`_chart_overlaps`)
    or it returns a nonzero code: the reference's rule. Otherwise the numpy
    path below, its plain version: charts grown over face adjacency within
    an angle of their seed's normal, each projected orthographically (in
    float64) onto its seed's tangent plane with its vertices welded, a
    chart whose projection overlaps itself (> 0.05 of its texels) demoted
    to one chart a face, and the chart boxes shelf-packed tallest first
    (stable) at one texel density, the scale searched down by x0.85 up to
    40 times; when no scale fits, `_per_face_unwrap`. Returns (vt (n, 2)
    float32 clipped to [0, 1], ft (F, 3) int64): the reference's numpy
    path, which the reference takes when its C++ unwrap is not built."""
    if native:
        from contexture_nerf_tpu_torch.native.objio import chart_unwrap_native

        got = chart_unwrap_native(vertices, faces, angle_thr_deg, gutter)
        if got is not None and not _chart_overlaps(*got):
            return got
    F = faces.shape[0]
    chart = _grow_charts(vertices, faces, angle_thr_deg)
    n_charts = int(chart.max()) + 1
    normals = _face_normals(vertices, faces)

    def project_chart(fids, seed_n):
        """(welded uvs (k,2) float64, ft_local (m,3)): the chart's faces
        projected onto the plane with normal seed_n."""
        up = np.array([0.0, 1.0, 0.0])
        if abs(float(seed_n @ up)) > 0.9:
            up = np.array([1.0, 0.0, 0.0])
        u = np.cross(up, seed_n)
        u /= max(np.linalg.norm(u), 1e-12)
        v = np.cross(seed_n, u)
        verts_used = np.unique(faces[fids].reshape(-1))
        local = {int(g): i for i, g in enumerate(verts_used)}
        p = vertices[verts_used]
        uv = np.stack([p @ u, p @ v], axis=-1)
        uv -= uv.min(axis=0)
        ft_local = np.vectorize(local.get)(faces[fids])
        return uv.astype(np.float64), ft_local

    charts = []  # (face ids, welded uvs (k,2), ft_local (m,3)) a chart
    for cid in range(n_charts):
        fids = np.nonzero(chart == cid)[0]
        uv, ft_local = project_chart(fids, normals[fids[0]])
        if len(fids) > 1 and _overlap_frac(uv, ft_local) > 0.05:
            # a projection that overlaps itself: one chart a face, each on
            # its own face's plane
            for f in fids:
                fi = np.asarray([f])
                charts.append((fi, *project_chart(fi, normals[f])))
        else:
            charts.append((fids, uv, ft_local))
    n_charts = len(charts)

    sizes = np.array([c[1].max(axis=0) if len(c[1]) else (0, 0)
                      for c in charts])  # (n_charts, 2) chart w, h
    order = np.argsort(-sizes[:, 1], kind="stable")  # tallest first

    def pack(scale):
        """Chart offsets (n_charts, 2) on shelves, or None on overflow."""
        offsets = np.zeros((n_charts, 2))
        x = y = shelf_h = 0.0
        for ci in order:
            w, h = sizes[ci] * scale
            if w > 1.0 - 2 * gutter or h > 1.0 - 2 * gutter:
                return None
            if x + w + 2 * gutter > 1.0:
                y += shelf_h
                x = shelf_h = 0.0
            if y + h + 2 * gutter > 1.0:
                return None
            offsets[ci] = (x + gutter, y + gutter)
            x += w + 2 * gutter
            shelf_h = max(shelf_h, h + 2 * gutter)
        return offsets

    total_area = float(np.prod(sizes + 1e-9, axis=1).sum())
    scale = np.sqrt(0.5 / max(total_area, 1e-12))
    offsets = None
    for _ in range(40):
        offsets = pack(scale)
        if offsets is not None:
            break
        scale *= 0.85
    if offsets is None:
        # the gutter caps the shelves at about (1/2g)^2 charts; a mesh that
        # welds nothing (a triangle soup) can have more
        return _per_face_unwrap(faces)

    vt_parts, ft = [], np.zeros((F, 3), np.int64)
    base = 0
    for ci, (fids, uv, ft_local) in enumerate(charts):
        vt_parts.append(uv * scale + offsets[ci])
        ft[fids] = ft_local + base
        base += uv.shape[0]
    vt = np.concatenate(vt_parts, axis=0).astype(np.float32)
    return np.clip(vt, 0.0, 1.0), ft


def atlas_cache_files(cache: Path, mesh: Mesh) -> Tuple[Path, Path]:
    """(vt_<tag>.npy, ft_<tag>.npy) in `cache`: the tag is the first 10 hex
    digits of the SHA-1 of the normalised vertices' bytes (float32) and
    then the faces' (int64), so a re-made mesh under the same name never
    reads a stale atlas."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mesh.vertices).tobytes())
    h.update(np.ascontiguousarray(mesh.faces).tobytes())
    tag = h.hexdigest()[:10]
    return cache / f"vt_{tag}.npy", cache / f"ft_{tag}.npy"


class TexturedMeshModel:
    """Mesh geometry, renderer and the texture lattice size. `opt` is the
    guide config (shape_path, shape_scale, dy, texture_interpolation_mode).
    `cache_path` is the directory of the mesh's unwrapped atlas (None: no
    cache). `compute_dtype` is the MLP's matmul dtype for the texture
    lattice: the card's fused kernels (K1, K2) compute in bf16.
    `edit_change_mask` ((1, res, res) f32, or None) marks the texels that
    guide.reference_texture says were edited (training/trainer.py
    `seed_texture_field`)."""

    def __init__(self, opt, render_grid_size: int = 1024,
                 texture_resolution: int = 1024,
                 cache_path: Optional[Path] = None, multires: int = 10,
                 fovyangle: float = math.pi / 3,
                 compute_dtype=torch.float32, device="cuda",
                 write_cache: bool = True):
        self.device = resolve_device(device)
        self.opt = opt
        self.dy = opt.dy
        self.mesh_scale = opt.shape_scale
        self.texture_resolution = texture_resolution
        self.cache_path = Path(cache_path) if cache_path is not None else None
        self.write_cache = write_cache
        self.multires = multires
        self.compute_dtype = compute_dtype
        self.default_color = [0.8, 0.1, 0.8]  # magenta
        self.dim = (render_grid_size, render_grid_size)
        self.edit_change_mask: Optional[torch.Tensor] = None
        self.renderer = Renderer(dim=self.dim,
                                 interpolation_mode=opt.texture_interpolation_mode,
                                 fovyangle=fovyangle, device=self.device)
        if not Path(opt.shape_path).exists():
            raise FileNotFoundError(
                f"guide.shape_path {opt.shape_path} does not exist")
        mesh = Mesh.load(opt.shape_path)
        mesh.normalize_mesh(inplace=True, target_scale=self.mesh_scale,
                            dy=self.dy)
        self.mesh = mesh
        self.vt, self.ft = self._init_texture_map()
        dev = self.device
        # (1, F, 3, 2) face UV attributes
        self.face_attributes = torch.from_numpy(self.vt[self.ft])[None].to(dev)
        self.verts = torch.from_numpy(mesh.vertices).float().to(dev)
        self.faces = torch.from_numpy(mesh.faces).long().to(dev)

    def _init_texture_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """(vt float32, ft int64), the first of: the mesh's own UVs; the
        atlas cached in cache_path for this geometry; `atlas_unwrap`, then
        written to the cache (unless write_cache is off: the ranks other
        than 0)."""
        mesh = self.mesh
        if (mesh.vt is not None and mesh.ft is not None
                and mesh.vt.shape[0] > 0 and mesh.ft.min() > -1):
            return mesh.vt.astype(np.float32), mesh.ft.astype(np.int64)
        files = (atlas_cache_files(self.cache_path, mesh)
                 if self.cache_path is not None else None)
        if files is not None and all(f.exists() for f in files):
            vt, ft = (np.load(f) for f in files)
            return vt.astype(np.float32), ft.astype(np.int64)
        vt, ft = atlas_unwrap(mesh.vertices, mesh.faces)
        if files is not None and self.write_cache:
            self.cache_path.mkdir(parents=True, exist_ok=True)
            for f, a in zip(files, (vt, ft)):
                # whole files only: another rank may read the cache
                tmp = f.with_name(f".{f.stem}.{os.getpid()}.npy")
                np.save(tmp, a)
                os.replace(tmp, f)
        return vt, ft

    def get_texture_map(self, mlp: NeRF2D
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """((1,3,res,res) texture in [0,1], raw MLP output (res^2, 3)) on
        the UV lattice, through the fused MLP (K1 on the card)."""
        return texture_from_mlp(mlp, self.texture_resolution, self.multires,
                                compute_dtype=self.compute_dtype)

    def apply_median_fill(self, texture: torch.Tensor) -> torch.Tensor:
        """Replace the texels near the default colour with the per-channel
        median of the painted texels. The median of the masked subset comes
        from a sort: unpainted texels are set to +inf so they land past the
        painted count, and the lower middle is taken (torch.median's
        convention); 0 when nothing is painted. (1,3,H,W) -> (1,3,H,W)."""
        default = torch.tensor(self.default_color, dtype=texture.dtype,
                               device=texture.device).reshape(1, 3, 1, 1)
        diff = (texture - default).abs().sum(dim=1, keepdim=True)
        default_mask = (diff < 0.1).to(texture.dtype)
        painted = 1.0 - default_mask
        n_painted = painted.sum().to(torch.int64)
        vals = torch.where(painted > 0, texture,
                           torch.tensor(float("inf"), dtype=texture.dtype,
                                        device=texture.device))
        svals = torch.sort(vals.reshape(texture.shape[1], -1), dim=1).values
        mid = (n_painted - 1).clamp(min=0) // 2
        median = torch.gather(svals, 1, mid.reshape(1, 1).expand(
            svals.shape[0], 1))[:, 0]
        median = torch.where(n_painted > 0, median, torch.zeros_like(median))
        return texture * painted + median.reshape(1, 3, 1, 1) * default_mask

    def query_texture_at_uv(self, mlp: NeRF2D, uv: torch.Tensor,
                            compute_dtype=None) -> torch.Tensor:
        """The MLP at arbitrary UVs (N,2) -> (N,3) colours in [0,1], through
        the fused MLP (K1 on the card), in the model's compute dtype unless
        one is given."""
        out = fused_nerf2d(mlp, uv.contiguous(), self.multires,
                           compute_dtype=compute_dtype or self.compute_dtype)
        return (torch.tanh(out) + 1.0) / 2.0

    def fit_texture_to_image(self, mlp: NeRF2D, image: torch.Tensor,
                             steps: int = 300, lr: float = 1e-3,
                             batch: int = 4096,
                             uv_draws: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
        """Fit the MLP in place to an image (3, R, R) in [0, 1]
        (guide.initial_texture): `steps` Adam steps (lr, betas (0.9, 0.999),
        eps 1e-8) on mean((colour(uv) - sample_texture(image, uv))^2) over
        batches of `batch` uniform UVs, through the fused MLP (K1 forward
        and K2 backward on the card). The UVs are `uv_draws` (steps, batch,
        2) when given, else drawn from `generator` one batch a step.
        Returns the loss of each step (steps,)."""
        dev = mlp.output_linear.weight.device
        img = image.to(dev, torch.float32)[None]  # (1, 3, R, R)
        opt = torch.optim.Adam(mlp.parameters(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        losses = torch.empty(steps, device=dev)
        for i in range(steps):
            if uv_draws is not None:
                uv = torch.as_tensor(uv_draws[i]).to(dev, torch.float32)
            else:
                uv = torch.rand((batch, 2), generator=generator, device=dev)
            opt.zero_grad(set_to_none=True)
            pred = self.query_texture_at_uv(mlp, uv)
            tgt = sample_texture(uv[None, None], img)[0, 0]  # (N, 3)
            loss = torch.mean((pred - tgt) ** 2)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
        mlp.zero_grad(set_to_none=True)
        return losses

    @torch.no_grad()
    def get_texture_map_only_valid_areas(self, mlp: NeRF2D) -> torch.Tensor:
        """The texture map with only the texels that a UV chart covers
        painted: the UV charts rasterized into the atlas grid (every z 1;
        K5 on the card), the MLP queried at the interpolated UVs (K1 on the
        card), its raw outputs unscaled (/ 0.5 * 0.8), zero elsewhere, rows
        flipped to the lattice orientation of get_texture_map.
        Returns (1,3,res,res)."""
        res = self.texture_resolution
        uv_attr = self.face_attributes  # (1, F, 3, 2)
        fvi = uv_attr * 2.0 - 1.0
        fvz = torch.ones(fvi.shape[:-1], device=fvi.device)
        face_idx, bary = rasterize_geometry(fvz, fvi, res, res)
        uvs = interpolate_attributes(face_idx, bary, uv_attr)  # (1,r,r,2)
        mlp_out = fused_nerf2d(mlp, uvs[0].reshape(-1, 2).contiguous(),
                               self.multires,
                               compute_dtype=self.compute_dtype)
        colors = (mlp_out / 0.5 * 0.8).reshape(res, res, 3)
        mask = (face_idx[0] >= 0)[..., None]
        img = torch.where(mask, colors, torch.zeros((), device=colors.device))
        return img.flip(0).permute(2, 0, 1)[None]

    def project(self, theta, phi, radius):
        """The mesh's faces seen from the given views: (camera transforms,
        camera-space (B,F,3,3), NDC (B,F,3,2), normals (B,F,3))."""
        return self.renderer.project(self.verts, self.faces, theta, phi,
                                     radius, look_at_height=self.dy)

    def render_geometry(self, theta=None, phi=None, radius=None,
                        dims: Optional[Tuple[int, int]] = None) -> RenderCache:
        theta = torch.atleast_1d(torch.as_tensor(theta, dtype=torch.float32))
        B = theta.shape[0]
        uv_attr = self.face_attributes.expand(B, -1, -1, -1)
        return self.renderer.render_geometry(
            self.verts, self.faces, uv_attr, theta, phi, radius,
            look_at_height=self.dy, dims=dims)

    def render(self, mlp: NeRF2D, theta=None, phi=None, radius=None,
               background: Union[None, str, torch.Tensor] = None,
               render_cache: Optional[RenderCache] = None,
               use_median: bool = False,
               dims: Optional[Tuple[int, int]] = None
               ) -> Dict[str, torch.Tensor]:
        """The render dict: image, mask, background, foreground, depth,
        normals, render_cache, texture_map, mlp_output. `background` is None
        (black), a (3,) colour, a (B,3,H,W) image, or one of the renderer's
        background types ('none', 'white', 'random'), which the renderer
        composites itself. use_median fills the texels left at the default
        colour with the painted texels' median (`apply_median_fill`)."""
        texture_img, mlp_output = self.get_texture_map(mlp)
        if use_median:
            texture_img = self.apply_median_fill(texture_img)
        out = self.render_texture(texture_img, theta, phi, radius,
                                  background, render_cache, dims)
        out["mlp_output"] = mlp_output
        return out

    def render_texture(self, texture_img: torch.Tensor, theta=None, phi=None,
                       radius=None,
                       background: Union[None, str, torch.Tensor] = None,
                       render_cache: Optional[RenderCache] = None,
                       dims: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
        """`render` with a texture map given in place of the MLP (no
        mlp_output): the eval renders one map for every frame."""
        if render_cache is None:
            render_cache = self.render_geometry(theta, phi, radius, dims=dims)
        background_type = background if isinstance(background, str) \
            else "none"
        pred_features, mask, depth, normals = \
            self.renderer.render_texture_with_cache(
                render_cache, texture_img, background_type)
        if isinstance(background, str):
            pred_map = pred_back = pred_features
        else:
            if background is None:
                background = torch.zeros(3)
            background = torch.as_tensor(background).to(pred_features)
            if background.dim() == 1:
                pred_back = torch.ones_like(pred_features) * \
                    background.reshape(1, 3, 1, 1)
            else:
                pred_back = background
            pred_map = pred_back * (1 - mask) + pred_features * mask
        return {"image": pred_map.clamp(0.0, 1.0), "mask": mask,
                "background": pred_back,
                "foreground": pred_features.clamp(0.0, 1.0), "depth": depth,
                "normals": normals, "render_cache": render_cache,
                "texture_map": texture_img}

    def render_face_normals_face_idx(self, theta, phi, radius, dims=None):
        """The geometry-only multiview render of the view weights (K5 on
        the card): (mask (B,1,H,W), depth (B,1,H,W), normals image
        (B,3,H,W): each pixel's face normal, 0 on the background, face
        normals (B,3,F), face index (B,1,H,W), -1 on the background)."""
        cache = self.render_geometry(theta, phi, radius, dims=dims)
        B, H, W = cache.face_idx.shape
        idx = cache.face_idx.clamp(min=0).reshape(B, -1, 1).long()
        normals = torch.gather(cache.face_normals, 1,
                               idx.expand(-1, -1, 3)).reshape(B, H, W, 3)
        normals = normals * cache.mask.permute(0, 2, 3, 1)
        return (cache.mask, cache.depth_map, normals.permute(0, 3, 1, 2),
                cache.face_normals.permute(0, 2, 1), cache.face_idx[:, None])

    # -- augmentations (host numpy / scipy; off in the paint loop, as in the
    # reference) ---------------------------------------------------------------

    def cotan_laplacian(self):
        """The cotangent-weight Laplacian of the mesh, scipy CSC (n, n)."""
        from scipy import sparse

        pts = np.asarray(self.mesh.vertices).T  # (3, N)
        tris = np.asarray(self.mesh.faces)
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        A, Bv, C = pts[:, a], pts[:, b], pts[:, c]
        eab, ebc, eca = Bv - A, C - Bv, A - C
        eab = eab / np.linalg.norm(eab, axis=0)
        ebc = ebc / np.linalg.norm(ebc, axis=0)
        eca = eca / np.linalg.norm(eca, axis=0)
        alpha = np.arccos(-np.sum(eca * eab, axis=0))
        beta = np.arccos(-np.sum(eab * ebc, axis=0))
        gamma = np.arccos(-np.sum(ebc * eca, axis=0))
        wab, wbc, wca = 1 / np.tan(gamma), 1 / np.tan(alpha), 1 / np.tan(beta)
        rows = np.concatenate((a, b, a, b, b, c, b, c, c, a, c, a))
        cols = np.concatenate((a, b, b, a, b, c, c, b, c, a, a, c))
        vals = np.concatenate((wab, wab, -wab, -wab, wbc, wbc, -wbc, -wbc,
                               wca, wca, -wca, -wca))
        n = pts.shape[1]
        return sparse.coo_matrix((vals, (rows, cols)), shape=(n, n),
                                 dtype=float).tocsc()

    def eigens(self, k: int = 20, e: float = 0.0):
        """The k smallest non-trivial eigenpairs of the Laplacian
        (shift-invert about e, the 1e-4 shift added back): (values (k,),
        vectors (k, n))."""
        import scipy.sparse as sparse
        from scipy.sparse.linalg import eigsh

        L = self.cotan_laplacian()
        shift = 1e-4
        vals, vecs = eigsh(L + shift * sparse.eye(L.shape[0]), k=k + 1,
                           which="LM", sigma=e, tol=1e-3)
        return (vals + shift)[1:], vecs[:, 1:].T

    @staticmethod
    def normalize_vertices(vertices: np.ndarray, mesh_scale: float = 1.0,
                           dy: float = 0.0) -> np.ndarray:
        """Centred, scaled to max radius mesh_scale, lifted by dy."""
        v = vertices - vertices.mean(axis=0)[None]
        v = v / np.linalg.norm(v, axis=1).max() * mesh_scale
        v[:, 1] += dy
        return v

    def spectral_augmentations(self, vertices: np.ndarray,
                               rng: np.random.Generator) -> np.ndarray:
        """A random low-frequency deformation along the vertex directions:
        one eigenvector from each half of the 20 lowest, each with a random
        sign, its range normalized, 0.25 of it; then normalized."""
        _, basis = self.eigens(20, 0.0)
        span = basis.max(axis=-1) - basis.min(axis=-1)
        basis = basis / span[:, None]
        k = 2
        interval = basis.shape[0] // k
        chosen = [int(rng.integers(0, min(interval, basis.shape[0] - i)))
                  + i for i in range(0, basis.shape[0], interval)]
        coeffs = np.zeros(basis.shape[0])
        coeffs[chosen] = (rng.random(len(chosen)) > 0.5) * 2.0 - 1.0
        recon = coeffs @ basis
        dirs = vertices / np.linalg.norm(vertices, axis=1)[:, None]
        deformed = vertices + 0.25 * recon[:, None] * dirs
        return self.normalize_vertices(deformed, self.mesh_scale, self.dy)

    def axis_augmentations(self, vertices: np.ndarray,
                           rng: np.random.Generator,
                           stretch_factor: float = 1.6,
                           squish_factor: float = 0.7) -> np.ndarray:
        """One random axis stretched, another squished; then normalized."""
        axes = rng.permutation(3)
        v = vertices.copy()
        v[:, axes[0]] *= stretch_factor
        v[:, axes[1]] *= squish_factor
        return self.normalize_vertices(v, self.mesh_scale, self.dy)

    def augment_vertices(self, rng: np.random.Generator) -> np.ndarray:
        """The mesh's vertices, each augmentation applied with
        probability 1/2 (spectral first)."""
        v = np.asarray(self.mesh.vertices).copy()
        if rng.random() < 0.5:
            v = self.spectral_augmentations(v, rng)
        if rng.random() < 0.5:
            v = self.axis_augmentations(v, rng)
        return v

    @torch.no_grad()
    def export_mesh(self, path, mlp: NeRF2D) -> None:
        """mesh.obj, mesh.mtl and albedo.png (the texture map, clipped,
        truncated to uint8) in `path`, the OBJ and MTL text line for line
        as the reference writes them."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        texture_img, _ = self.get_texture_map(mlp)
        colors = texture_img.clamp(0, 1).permute(0, 2, 3, 1)[0].cpu().numpy()
        save_image((colors * 255).astype(np.uint8), path / "albedo.png")

        v_np = np.asarray(self.mesh.vertices)
        f_np = np.asarray(self.mesh.faces)
        vt_np = np.asarray(self.vt)
        ft_np = np.asarray(self.ft)
        with open(path / "mesh.obj", "w") as fp:
            fp.write("mtllib mesh.mtl \n")
            for v in v_np:
                fp.write(f"v {v[0]} {v[1]} {v[2]} \n")
            for v in vt_np:
                fp.write(f"vt {v[0]} {v[1]} \n")
            fp.write("usemtl mat0 \n")
            for i in range(len(f_np)):
                fp.write(
                    f"f {f_np[i, 0] + 1}/{ft_np[i, 0] + 1} "
                    f"{f_np[i, 1] + 1}/{ft_np[i, 1] + 1} "
                    f"{f_np[i, 2] + 1}/{ft_np[i, 2] + 1} \n")
        with open(path / "mesh.mtl", "w") as fp:
            fp.write("newmtl mat0 \n")
            fp.write("Ka 1.000000 1.000000 1.000000 \n")
            fp.write("Kd 1.000000 1.000000 1.000000 \n")
            fp.write("Ks 0.000000 0.000000 0.000000 \n")
            fp.write("Tr 1.000000 \n")
            fp.write("illum 1 \n")
            fp.write("Ns 0.000000 \n")
            fp.write("map_Kd albedo.png \n")
