"""The benchmark's own plain geometry of a mesh's six Zero123++ target
views: an OBJ reader, the look-at perspective camera, a plain rasterizer
(each band of pixel rows against every face that reaches it, in face
chunks; image-space barycentrics; the closest face wins, the lowest index
among equals: the port's plain rasterizer's result) and the crops that
make the 3x2 grids. Both the program and the reference take what it makes
as inputs: the depth, mask and UV grids, and for the exact path the views'
UV and mask maps and crop boxes.

The conventions are those of the trainer's geometry pass: views at azimuths
30, 150, 270, 90, 210, 330 degrees and elevations 30, 30, 30, -20, -20,
-20, radius 1.5, fovy pi/3, looking at (0, dy, 0); the mesh centred,
scaled to radius shape_scale and lifted by dy.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference.sds import crop_and_resize, merge_6_to_grid

AZIMUTHS = (30, 150, 270, 90, 210, 330)
ELEVATIONS = (30, 30, 30, -20, -20, -20)
FOVY = math.pi / 3


def read_obj(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(vertices (N,3), faces (F,3), uvs (T,2), face uv indices (F,3)) of a
    triangulated OBJ with v/vt face entries (polygons fan-triangulated)."""
    v, vt, f, ft = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                v.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vt.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = [p.split("/") for p in parts[1:]]
                vi = [int(p[0]) - 1 for p in idx]
                ti = [int(p[1]) - 1 for p in idx]
                for k in range(1, len(vi) - 1):
                    f.append([vi[0], vi[k], vi[k + 1]])
                    ft.append([ti[0], ti[k], ti[k + 1]])
    return (np.asarray(v, np.float32), np.asarray(f, np.int64),
            np.asarray(vt, np.float32), np.asarray(ft, np.int64))


def normalize(vertices: np.ndarray, scale: float, dy: float) -> np.ndarray:
    v = vertices.astype(np.float32)
    v = v - v.mean(axis=0)
    v = v / np.linalg.norm(v, axis=1).max() * scale
    v[:, 1] += dy
    return v


def camera_transforms(thetas, phis, radius, look_at_height, device):
    """(B, 4, 3) world-to-camera transforms: verts_camera = [v, 1] @ M."""
    th = torch.tensor(thetas, dtype=torch.float32, device=device)
    ph = torch.tensor(phis, dtype=torch.float32, device=device)
    pos = torch.stack([radius * torch.sin(th) * torch.sin(ph),
                       radius * torch.cos(th),
                       radius * torch.sin(th) * torch.cos(ph)], dim=-1)
    look = torch.zeros_like(pos)
    look[:, 1] = look_at_height
    up = torch.tensor([0.0, 1.0, 0.0], device=device).expand_as(pos)
    z = pos - look
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    rot = torch.stack([x, y, z], dim=-1)
    trans = -torch.einsum("bi,bij->bj", pos, rot)[:, None, :]
    return torch.cat([rot, trans], dim=1)


def rasterize(fvz: torch.Tensor, fvi: torch.Tensor, height: int, width: int,
              face_chunk: int = 64, band: int = 64):
    """fvz (B,F,3) camera z, fvi (B,F,3,2) NDC -> (face_idx (B,H,W) int32,
    -1 on background; bary (B,H,W,3)). Pixel (iy, ix) sits at NDC
    ((ix + 0.5) / W * 2 - 1, 1 - (iy + 0.5) / H * 2). Each band of `band`
    rows is tested against the faces whose NDC y-range reaches it, in face
    order, so the closest face wins and the lowest index among equals."""
    B, F = fvz.shape[:2]
    dev = fvz.device
    x0, y0 = fvi[..., 0, 0], fvi[..., 0, 1]
    x1, y1 = fvi[..., 1, 0], fvi[..., 1, 1]
    x2, y2 = fvi[..., 2, 0], fvi[..., 2, 1]
    den = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ca = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1)
    cb = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1)
    cc = torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2,
                      x0 * y1 - x1 * y0], dim=-1)
    valid = den.abs() > 1e-12
    den = torch.where(valid, den, torch.ones_like(den))
    y_lo = fvi[..., 1].amin(dim=-1).cpu()
    y_hi = fvi[..., 1].amax(dim=-1).cpu()
    xs = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5) \
        / width * 2 - 1
    ys = 1 - (torch.arange(height, device=dev, dtype=torch.float32) + 0.5) \
        / height * 2
    face_idx = torch.full((B, height, width), -1, dtype=torch.int32,
                          device=dev)
    bary = torch.zeros((B, height, width, 3), device=dev)
    for r0 in range(0, height, band):
        r1 = min(r0 + band, height)
        yb = ys[r0:r1]
        top, bottom = float(yb.max()), float(yb.min())
        px = xs.repeat(r1 - r0)[:, None]
        py = yb.repeat_interleave(width)[:, None]
        P = px.shape[0]
        for b in range(B):
            hit = ((y_hi[b] >= bottom) & (y_lo[b] <= top)).nonzero()[:, 0]
            if hit.numel() == 0:
                continue
            hit = hit.to(dev)
            best = torch.full((P,), float("-inf"), device=dev)
            idx = torch.full((P,), -1, dtype=torch.int32, device=dev)
            bc = torch.zeros((P, 3), device=dev)
            for s in range(0, hit.numel(), face_chunk):
                f = hit[s:s + face_chunk]
                w = [(px * ca[b, f, k] + py * cb[b, f, k] + cc[b, f, k])
                     / den[b, f] for k in range(3)]
                inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & valid[b, f]
                zz = fvz[b, f]
                z = w[0] * zz[:, 0] + w[1] * zz[:, 1] + w[2] * zz[:, 2]
                z = torch.where(inside, z, torch.full_like(z, float("-inf")))
                arg = torch.argmax(z, dim=1)
                cand = z.gather(1, arg[:, None])[:, 0]
                better = cand > best
                best = torch.where(better, cand, best)
                idx = torch.where(better, f[arg].to(torch.int32), idx)
                cb_ = torch.stack([wk.gather(1, arg[:, None])[:, 0]
                                   for wk in w], dim=-1)
                bc = torch.where(better[:, None], cb_, bc)
            face_idx[b, r0:r1] = idx.reshape(r1 - r0, width)
            bary[b, r0:r1] = bc.reshape(r1 - r0, width, 3)
    return face_idx, bary


def interpolate(face_idx, bary, face_features):
    """(B,H,W) faces, (B,H,W,3) barycentrics, (B,F,3,C) -> (B,H,W,C)."""
    B, H, W = face_idx.shape
    C = face_features.shape[-1]
    safe = face_idx.clamp(min=0).reshape(B, H * W).long()
    vals = torch.gather(face_features, 1,
                        safe[:, :, None, None].expand(B, H * W, 3, C))
    w = bary.reshape(B, H * W, 3, 1)
    out = (w * vals).sum(dim=2).reshape(B, H, W, C)
    return out * (face_idx >= 0)[..., None]


def nonzero_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Square box with a 10% margin around a (H, W) mask's nonzero pixels:
    (min_h, min_w, max_h, max_w)."""
    nz = np.nonzero(mask)
    min_h, max_h = int(nz[0].min()), int(nz[0].max())
    min_w, max_w = int(nz[1].min()), int(nz[1].max())
    size = max(max_h - min_h + 1, max_w - min_w + 1) * 1.1
    h0 = min_h - (size - (max_h - min_h + 1)) / 2
    w0 = min_w - (size - (max_w - min_w + 1)) / 2
    min_h, min_w = max(0, int(h0)), max(0, int(w0))
    return (min_h, min_w, min(mask.shape[0], int(min_h + size)),
            min(mask.shape[1], int(min_w + size)))


def six_views(obj_path, render_px: int, tile_px: int, shape_scale: float,
              dy: float, radius: float, device) -> Dict:
    """The six target views of the mesh at render_px^2 and their grids of
    tile_px tiles: depth_grid (1,3,3t,2t) (depth on grey), mask_grid
    (1,1,3t,2t), uv_pts (6 t^2, 2), and the views' maps for the exact path:
    cache (the nine fields the renderer's cache holds, in its order),
    bboxes6."""
    verts, faces, vt, ft = read_obj(obj_path)
    verts = torch.from_numpy(normalize(verts, shape_scale, dy)).to(device)
    faces = torch.from_numpy(faces).to(device)
    thetas = [math.radians(90 - e) for e in ELEVATIONS]
    phis = [math.radians(a) % (2 * math.pi) for a in AZIMUTHS]
    M = camera_transforms(thetas, phis, radius, dy, device)
    B = M.shape[0]
    ones = torch.ones((verts.shape[0], 1), device=device)
    vc = torch.einsum("nk,bkj->bnj", torch.cat([verts, ones], -1), M)
    tanf = math.tan(FOVY / 2)
    proj = torch.tensor([1 / tanf, 1 / tanf, -1.0], device=device)
    pr = vc * proj
    vi = pr[..., :2] / pr[..., 2:3]
    fvc, fvi = vc[:, faces], vi[:, faces]
    n = torch.linalg.cross(fvc[:, :, 1] - fvc[:, :, 0],
                           fvc[:, :, 2] - fvc[:, :, 0], dim=-1)
    normals = n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    face_idx, bary = rasterize(fvc[..., 2], fvi, render_px, render_px)
    mask = (face_idx > -1).float()
    raw = interpolate(face_idx, bary, fvc[..., 2:3])[..., 0]
    obj = mask > 0
    lo = torch.where(obj, raw, torch.full_like(raw, float("inf"))).amin(
        dim=(1, 2), keepdim=True)
    hi = torch.where(obj, raw, torch.full_like(raw, float("-inf"))).amax(
        dim=(1, 2), keepdim=True)
    rng = torch.where(hi - lo == 0, torch.ones_like(hi), hi - lo)
    depth = torch.where(obj, (raw - lo) / rng, torch.zeros_like(raw))
    uv_attr = torch.from_numpy(vt[ft]).to(device)[None].expand(B, -1, -1, -1)
    uv = interpolate(face_idx, bary, uv_attr)
    masks = mask[:, None]
    bboxes = [nonzero_box(m) for m in masks[:, 0].cpu().numpy()]
    uv_maps = uv.permute(0, 3, 1, 2)
    depth_maps = 1.0 - depth[:, None]
    tp = tile_px
    d_tiles, uv_tiles, m_tiles = [], [], []
    for i, box in enumerate(bboxes):
        a = crop_and_resize(masks[i:i + 1], box, tp, tp)
        d = crop_and_resize(depth_maps[i:i + 1], box, tp, tp)
        d_tiles.append(torch.cat([d, d, d], dim=1) * a + 0.5 * (1 - a))
        uvm = crop_and_resize(uv_maps[i:i + 1] * masks[i:i + 1], box, tp, tp)
        uv_tiles.append(uvm / a.clamp(min=1e-6))
        m_tiles.append(a)
    uv_grid = merge_6_to_grid(torch.cat(uv_tiles))
    cache = (M, uv, normals, face_idx, depth[:, None], raw[:, None], fvi,
             bary, masks)
    return {"depth_grid": merge_6_to_grid(torch.cat(d_tiles)),
            "mask_grid": merge_6_to_grid(torch.cat(m_tiles)),
            "uv_pts": uv_grid[0].permute(1, 2, 0).reshape(-1, 2).clamp(
                0.0, 1.0).contiguous(),
            "cache": cache, "bboxes6": bboxes}
