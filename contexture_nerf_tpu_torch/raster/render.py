"""Multi-view mesh renderer; the port's counterpart of
contexture_nerf_tpu/raster/render.py (`RenderCache`,
`normalize_multiple_depth`, `Renderer.render_geometry`,
`Renderer.render_texture_with_cache`, and the kaolin-compatible
`Renderer.render_multiple_view_texture`).

The geometry pass rasterizes every view once (K5 on the card, one launch
for all views) and keeps its buffers in a `RenderCache`; texture passes then
only sample the texture at the cached UVs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from contexture_nerf_tpu_torch.ops.texture import sample_texture
from contexture_nerf_tpu_torch.raster import camera as cam
from contexture_nerf_tpu_torch.raster.raster_kernel import rasterize_geometry
from contexture_nerf_tpu_torch.raster.rasterize import interpolate_attributes


class RenderCache(NamedTuple):
    """View-dependent buffers of one geometry pass."""

    camera_transform: torch.Tensor  # (B, 4, 3)
    uv_features: torch.Tensor  # (B, H, W, 2)
    face_normals: torch.Tensor  # (B, F, 3) camera-space unit normals
    face_idx: torch.Tensor  # (B, H, W) int32, -1 = background
    depth_map: torch.Tensor  # (B, 1, H, W) normalized [0, 1]
    raw_depth_map: torch.Tensor  # (B, 1, H, W) camera z (< 0 on object)
    face_vertices_image: torch.Tensor  # (B, F, 3, 2)
    bary: torch.Tensor  # (B, H, W, 3)
    mask: torch.Tensor  # (B, 1, H, W) float


def normalize_multiple_depth(raw_depth: torch.Tensor, mask: torch.Tensor,
                             min_val: float = 0.0) -> torch.Tensor:
    """Per-view masked min/max normalization of (B,H,W) camera z: the
    nearest surface -> 1, the farthest -> min_val, background 0."""
    obj = mask > 0
    inf = torch.tensor(float("inf"), dtype=raw_depth.dtype,
                       device=raw_depth.device)
    min_d = torch.where(obj, raw_depth, inf).amin(dim=(1, 2), keepdim=True)
    max_d = torch.where(obj, raw_depth, -inf).amax(dim=(1, 2), keepdim=True)
    rng = torch.where(max_d - min_d == 0, torch.ones_like(max_d),
                      max_d - min_d)
    return torch.where(obj, (1 - min_val) * (raw_depth - min_d) / rng
                       + min_val, torch.zeros_like(raw_depth))


class Renderer:
    """Perspective renderer (fovy pi/3 by default) on one device."""

    def __init__(self, dim: Tuple[int, int] = (1200, 1200),
                 interpolation_mode: str = "bilinear",
                 fovyangle: float = math.pi / 3, device="cuda"):
        if interpolation_mode not in ("nearest", "bilinear", "bicubic"):
            raise ValueError(f"no interpolation mode {interpolation_mode}")
        self.dim = dim
        self.interpolation_mode = ("bilinear" if interpolation_mode ==
                                   "bicubic" else interpolation_mode)
        self.device = torch.device(device)
        self.camera_projection = cam.perspective_projection(
            fovyangle, device=self.device)

    def project(self, verts: torch.Tensor, faces: torch.Tensor, elev, azim,
                radius, look_at_height: float = 0.0):
        """Per-view camera transforms (B,4,3) and the faces in camera space
        (B,F,3,3), in NDC (B,F,3,2), with unit normals (B,F,3)."""
        camera_transform = cam.get_camera_from_view(
            elev, azim, radius, look_at_height, device=self.device)
        fvc, fvi, face_normals = cam.prepare_vertices(
            verts, faces, self.camera_projection, camera_transform)
        return camera_transform, fvc, fvi, face_normals

    def render_geometry(self, verts: torch.Tensor, faces: torch.Tensor,
                        uv_face_attr: torch.Tensor, elev, azim, radius,
                        look_at_height: float = 0.0,
                        dims: Optional[Tuple[int, int]] = None
                        ) -> RenderCache:
        """Camera transforms, vertex projection, one rasterization of all
        views, depth (raw and normalized), interpolated UVs, face normals."""
        dims = self.dim if dims is None else dims
        h, w = dims[1], dims[0]
        camera_transform, fvc, fvi, face_normals = self.project(
            verts, faces, elev, azim, radius, look_at_height)
        face_idx, bary = rasterize_geometry(fvc[..., 2], fvi, h, w)
        mask = (face_idx > -1).float()
        raw_depth = interpolate_attributes(face_idx, bary,
                                           fvc[..., 2:3])[..., 0]
        depth = normalize_multiple_depth(raw_depth, mask)
        uv_features = interpolate_attributes(face_idx, bary, uv_face_attr)
        return RenderCache(
            camera_transform=camera_transform, uv_features=uv_features,
            face_normals=face_normals, face_idx=face_idx,
            depth_map=depth[:, None], raw_depth_map=raw_depth[:, None],
            face_vertices_image=fvi, bary=bary, mask=mask[:, None])

    def render_texture_with_cache(self, cache: RenderCache,
                                  texture_map: torch.Tensor,
                                  background_type: str = "none",
                                  background_noise: Optional[
                                      torch.Tensor] = None):
        """Sample texture_map (B|1, 3, TH, TW) at the cached UVs. Returns
        (image (B,3,H,W); mask (B,1,H,W); depth (B,1,H,W); normals
        (B,3,H,W)). The image's background is zero ("none"), one
        ("white") or `background_noise` (B|1,1,1,3) ("random"; zero when
        not given)."""
        image = sample_texture(cache.uv_features, texture_map,
                               self.interpolation_mode)  # (B,H,W,3)
        mask_hw1 = cache.mask.permute(0, 2, 3, 1)
        image = image * mask_hw1
        if background_type == "white":
            image = image + 1.0 * (1 - mask_hw1)
        elif background_type == "random":
            noise = (background_noise if background_noise is not None
                     else torch.zeros((1, 1, 1, 3), dtype=image.dtype,
                                      device=image.device))
            image = image + noise * (1 - mask_hw1)
        elif background_type != "none":
            raise ValueError(f"no background type {background_type!r}")
        B, H, W = cache.face_idx.shape
        safe = cache.face_idx.clamp(min=0).reshape(B, -1).long()
        normals = torch.gather(cache.face_normals, 1,
                               safe[..., None].expand(-1, -1, 3))
        normals = normals.reshape(B, H, W, 3) * mask_hw1
        return (image.permute(0, 3, 1, 2), cache.mask, cache.depth_map,
                normals.permute(0, 3, 1, 2))

    def render_multiple_view_texture(self, verts: torch.Tensor,
                                     faces: torch.Tensor,
                                     uv_face_attr: torch.Tensor,
                                     texture_map: torch.Tensor, elev=None,
                                     azim=None, radius=None,
                                     look_at_height: float = 0.0,
                                     dims: Optional[Tuple[int, int]] = None,
                                     background_type: str = "none",
                                     render_cache: Optional[
                                         RenderCache] = None):
        """kaolin-compatible entry: `render_geometry` (unless a cache is
        given), then `render_texture_with_cache`. Returns (image (B,3,H,W),
        mask (B,1,H,W), depth (B,1,H,W), normals (B,3,H,W), cache)."""
        if render_cache is None:
            render_cache = self.render_geometry(
                verts, faces, uv_face_attr, elev, azim, radius,
                look_at_height=look_at_height, dims=dims)
        image, mask, depth, normals = self.render_texture_with_cache(
            render_cache, texture_map, background_type)
        return image, mask, depth, normals, render_cache
