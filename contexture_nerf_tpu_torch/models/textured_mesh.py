"""Textured mesh model: mesh + renderer + the texture MLP's lattice; the
port's counterpart of contexture_nerf_tpu/models/textured_mesh.py
`TexturedMeshModel` (`render_geometry`, `render`, `get_texture_map`,
`apply_median_fill`, `query_texture_at_uv`,
`get_texture_map_only_valid_areas`, `export_mesh`) for meshes that carry
UVs.

As in the reference, the MLP's parameters are outside the model: every
texture call takes the NeRF2D module. A mesh without UVs needs the
reference's `atlas_unwrap`, which a later slice ports.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.models.fields import NeRF2D, texture_from_mlp
from contexture_nerf_tpu_torch.models.mesh import Mesh
from contexture_nerf_tpu_torch.ops.image import save_image
from contexture_nerf_tpu_torch.ops.mlp_kernel import fused_nerf2d
from contexture_nerf_tpu_torch.raster.raster_kernel import rasterize_geometry
from contexture_nerf_tpu_torch.raster.rasterize import interpolate_attributes
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
        self.default_color = [0.8, 0.1, 0.8]  # magenta
        self.dim = (render_grid_size, render_grid_size)
        self.renderer = Renderer(dim=self.dim,
                                 interpolation_mode=opt.texture_interpolation_mode,
                                 fovyangle=fovyangle, device=self.device)
        if not Path(opt.shape_path).exists():
            raise FileNotFoundError(
                f"guide.shape_path {opt.shape_path} does not exist")
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
