"""Textured mesh model: mesh + renderer + the texture MLP's lattice; the
port's counterpart of contexture_nerf_tpu/models/textured_mesh.py
`TexturedMeshModel` (`render_geometry`, `render`, `get_texture_map`) for
meshes that carry UVs.

As in the reference, the MLP's parameters are outside the model: every
texture call takes the NeRF2D module. A mesh without UVs needs the
reference's `atlas_unwrap`, which a later slice ports.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.models.fields import NeRF2D, texture_from_mlp
from contexture_nerf_tpu_torch.models.mesh import Mesh
from contexture_nerf_tpu_torch.raster.render import RenderCache, Renderer


class TexturedMeshModel:
    """Mesh geometry, renderer and the texture lattice size. `opt` is the
    guide config (shape_path, shape_scale, dy, texture_interpolation_mode).
    `compute_dtype` is the MLP's matmul dtype for the texture lattice: the
    card's fused kernel (K1) computes in bf16."""

    def __init__(self, opt, render_grid_size: int = 1024,
                 texture_resolution: int = 1024, multires: int = 10,
                 fovyangle: float = math.pi / 3,
                 compute_dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.opt = opt
        self.dy = opt.dy
        self.texture_resolution = texture_resolution
        self.multires = multires
        self.compute_dtype = compute_dtype
        self.dim = (render_grid_size, render_grid_size)
        self.renderer = Renderer(dim=self.dim,
                                 interpolation_mode=opt.texture_interpolation_mode,
                                 fovyangle=fovyangle, device=self.device)
        mesh = Mesh.load(opt.shape_path)
        mesh.normalize_mesh(inplace=True, target_scale=opt.shape_scale,
                            dy=self.dy)
        self.mesh = mesh
        if not (mesh.vt is not None and mesh.ft is not None
                and mesh.vt.shape[0] > 0 and mesh.ft.min() > -1):
            raise NotImplementedError(
                f"{opt.shape_path} has no UVs: a mesh without them needs "
                "atlas_unwrap (models/textured_mesh.py of the JAX package), "
                "which a later slice ports")
        self.vt = mesh.vt.astype(np.float32)
        self.ft = mesh.ft.astype(np.int64)
        dev = self.device
        # (1, F, 3, 2) face UV attributes
        self.face_attributes = torch.from_numpy(self.vt[self.ft])[None].to(dev)
        self.verts = torch.from_numpy(mesh.vertices).float().to(dev)
        self.faces = torch.from_numpy(mesh.faces).long().to(dev)

    def get_texture_map(self, mlp: NeRF2D
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """((1,3,res,res) texture in [0,1], raw MLP output (res^2, 3)) on
        the UV lattice, through the fused MLP (K1 on the card)."""
        return texture_from_mlp(mlp, self.texture_resolution, self.multires,
                                compute_dtype=self.compute_dtype)

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
               background=None, render_cache: Optional[RenderCache] = None,
               dims: Optional[Tuple[int, int]] = None
               ) -> Dict[str, torch.Tensor]:
        """The render dict: image (composited on `background`, clamped to
        [0, 1]), mask, background, foreground, depth, normals, render_cache,
        texture_map, mlp_output. `background` is None (black), a (3,) colour
        or a (B,3,H,W) image. (The reference's 'white' / 'random' background
        modes serve the eval renders of a later slice.)"""
        if render_cache is None:
            render_cache = self.render_geometry(theta, phi, radius, dims=dims)
        texture_img, mlp_output = self.get_texture_map(mlp)
        pred_features, mask, depth, normals = \
            self.renderer.render_texture_with_cache(render_cache, texture_img)
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
                "texture_map": texture_img, "mlp_output": mlp_output}
