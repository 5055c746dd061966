"""Camera math: perspective projection and look-at transforms; the port's
counterpart of contexture_nerf_tpu/raster/camera.py (kaolin's legacy
conventions).

  - camera space: right-handed, the camera looks down -z, y up;
  - projection vector p = [1/(ratio*tan(fovy/2)), 1/tan(fovy/2), -1];
    image coords = (v * p)[:2] / (v * p)[2], NDC in [-1, 1], y up;
  - a camera transform is (B, 4, 3): verts_camera = [verts, 1] @ M.
"""

from __future__ import annotations

import torch


def perspective_projection(fovy: float, ratio: float = 1.0,
                           device="cpu") -> torch.Tensor:
    """fovy (radians) -> projection vector [fx, fy, -1] (f32)."""
    tanfov = torch.tan(torch.tensor(float(fovy), dtype=torch.float32) / 2.0)
    return torch.stack([1.0 / (ratio * tanfov), 1.0 / tanfov,
                        -torch.ones_like(tanfov)]).to(device)


def camera_transform_from_lookat(pos: torch.Tensor, look_at: torch.Tensor,
                                 up: torch.Tensor) -> torch.Tensor:
    """(B,3) pos / look_at / up -> (B,4,3) world-to-camera transform."""
    z_axis = pos - look_at
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=-1, keepdim=True)
    x_axis = torch.linalg.cross(up, z_axis, dim=-1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    rot = torch.stack([x_axis, y_axis, z_axis], dim=-1)  # (B, 3, 3)
    trans = -torch.einsum("bi,bij->bj", pos, rot)[:, None, :]
    return torch.cat([rot, trans], dim=1)


def get_camera_from_view(elev, azim, r, look_at_height: float = 0.0,
                         device="cpu") -> torch.Tensor:
    """Spherical (elev = polar theta, azim = phi, radius) -> (B,4,3):
    pos = r (sin e sin a, cos e, sin e cos a), looking at
    (0, look_at_height, 0) with +y up."""
    def vec(x):
        return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32,
                                                device=device))

    elev, azim = vec(elev), vec(azim)
    r = torch.broadcast_to(vec(r), elev.shape)
    x = r * torch.sin(elev) * torch.sin(azim)
    y = r * torch.cos(elev)
    z = r * torch.sin(elev) * torch.cos(azim)
    pos = torch.stack([x, y, z], dim=-1)
    look_at = torch.zeros_like(pos)
    look_at[:, 1] = look_at_height
    up = torch.tensor([0.0, 1.0, 0.0], device=device).expand_as(pos)
    return camera_transform_from_lookat(pos, look_at, up)


def perspective_camera(points: torch.Tensor,
                       camera_proj: torch.Tensor) -> torch.Tensor:
    """Camera-space points (B,N,3) -> NDC (B,N,2)."""
    projected = points * camera_proj.reshape(1, 1, 3)
    return projected[..., :2] / projected[..., 2:3]


def rotate_translate_points(points: torch.Tensor,
                            camera_transform: torch.Tensor) -> torch.Tensor:
    """(B|1,N,3) world points x (B,4,3) -> (B,N,3) camera-space points."""
    if points.dim() == 2:
        points = points[None]
    ones = torch.ones((*points.shape[:-1], 1), dtype=points.dtype,
                      device=points.device)
    padded = torch.cat([points, ones], dim=-1)
    return torch.einsum("bnk,bkj->bnj", padded, camera_transform)


def face_normals_from_verts(face_vertices: torch.Tensor,
                            unit: bool = True) -> torch.Tensor:
    """(B,F,3,3) face vertices -> (B,F,3) face normals."""
    v0, v1, v2 = (face_vertices[:, :, 0], face_vertices[:, :, 1],
                  face_vertices[:, :, 2])
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if unit:
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-12)
    return n


def prepare_vertices(vertices: torch.Tensor, faces: torch.Tensor,
                     camera_proj: torch.Tensor,
                     camera_transform: torch.Tensor):
    """World vertices (N,3) or (B,N,3), faces (F,3), transforms (B,4,3) ->
    (face_vertices_camera (B,F,3,3), face_vertices_image (B,F,3,2),
    face_normals (B,F,3))."""
    vertices_camera = rotate_translate_points(vertices, camera_transform)
    vertices_image = perspective_camera(vertices_camera, camera_proj)
    face_vertices_camera = vertices_camera[:, faces]
    face_vertices_image = vertices_image[:, faces]
    normals = face_normals_from_verts(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, normals
