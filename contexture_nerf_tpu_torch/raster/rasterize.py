"""Triangle visibility and attribute interpolation; the port's counterpart
of contexture_nerf_tpu/raster/rasterize.py (`pixel_grid`,
`face_edge_setup`, `rasterize_geometry`, `interpolate_attributes` and the
kaolin-compatible `rasterize`).

`rasterize_geometry` here is the plain PyTorch version of the rasterizer
kernel (K5, raster/raster_kernel.py and csrc/raster.cu): a loop over face
chunks that tests every pixel against every face. Conventions:
  - pixel (iy, ix) has its centre at NDC x = (ix + 0.5) / W * 2 - 1,
    y = 1 - (iy + 0.5) / H * 2 (row 0 is the top of the frame);
  - barycentrics are image-space edge functions (not perspective-correct);
    a pixel is inside a face when all three are >= 0;
  - the visible face maximizes the interpolated camera-space z (z < 0 in
    front, so larger is closer); among equal z the lowest face index wins,
    as the reference's first-occurrence argmax over in-order chunks does;
  - faces with |den| <= 1e-12 (degenerate) are never hit.
The edge functions are evaluated as ((x a + y b) + c) / den and z as
(w0 z0 + w1 z1) + w2 z2, one rounding per operation, so the kernel can
repeat them bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-12


def pixel_centers(height: int, width: int, device="cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC coordinates of pixel centres: (ys (H,), xs (W,)) f32."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device)
                + 0.5) / height * 2.0
    return ys, xs


def pixel_grid(height: int, width: int, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC coordinates of pixel centres as a meshgrid: (y (H,W), x (H,W))."""
    ys, xs = pixel_centers(height, width, device)
    return torch.meshgrid(ys, xs, indexing="ij")


def face_edge_setup(face_vertices_image: torch.Tensor):
    """Per-face linear barycentric coefficients of (..., F, 3, 2) NDC
    vertices: (coef_a, coef_b, coef_c) each (..., F, 3) with
    w_k(x, y) = (a_k x + b_k y + c_k) / den, and den (..., F), the signed
    twice-area."""
    v = face_vertices_image
    x0, y0 = v[..., 0, 0], v[..., 0, 1]
    x1, y1 = v[..., 1, 0], v[..., 1, 1]
    x2, y2 = v[..., 2, 0], v[..., 2, 1]
    den = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    coef_a = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1)
    coef_b = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1)
    coef_c = torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2,
                          x0 * y1 - x1 * y0], dim=-1)
    return coef_a, coef_b, coef_c, den


def rasterize_geometry(face_vertices_z: torch.Tensor,
                       face_vertices_image: torch.Tensor,
                       height: int, width: int, face_chunk: int = 64):
    """Plain visibility pass: face_vertices_z (B, F, 3) camera-space z,
    face_vertices_image (B, F, 3, 2) NDC -> (face_idx (B, H, W) int32, -1
    for background; bary (B, H, W, 3) f32, zero on background)."""
    B, F = face_vertices_z.shape[:2]
    dev = face_vertices_z.device
    fvz = face_vertices_z.float()
    ca, cb, cc, den = face_edge_setup(face_vertices_image.float())
    valid = den.abs() > EPS
    den_safe = torch.where(den.abs() < EPS, torch.ones_like(den), den)
    ys, xs = pixel_centers(height, width, dev)
    px = xs.repeat(height)[:, None]  # (P, 1)
    py = ys.repeat_interleave(width)[:, None]
    P = height * width
    face_idx = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((B, P, 3), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for b in range(B):
        best_z = torch.full((P,), float("-inf"), device=dev)
        best_idx = face_idx[b]
        best_bary = bary[b]
        for s in range(0, F, face_chunk):
            e = min(s + face_chunk, F)
            d = den_safe[b, s:e]
            w = [(px * ca[b, s:e, k] + py * cb[b, s:e, k] + cc[b, s:e, k]) / d
                 for k in range(3)]  # 3 x (P, C)
            inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & valid[b, s:e]
            zz = fvz[b, s:e]
            z = w[0] * zz[:, 0] + w[1] * zz[:, 1] + w[2] * zz[:, 2]
            z = torch.where(inside, z, neg_inf)
            arg = torch.argmax(z, dim=1)  # first occurrence among equal z
            cand_z = z.gather(1, arg[:, None])[:, 0]
            better = cand_z > best_z
            best_z = torch.where(better, cand_z, best_z)
            best_idx.copy_(torch.where(better, (s + arg).to(torch.int32),
                                       best_idx))
            cand_bary = torch.stack([wk.gather(1, arg[:, None])[:, 0]
                                     for wk in w], dim=-1)
            best_bary.copy_(torch.where(better[:, None], cand_bary,
                                        best_bary))
    return face_idx.reshape(B, height, width), bary.reshape(B, height, width, 3)


def interpolate_attributes(face_idx: torch.Tensor, bary: torch.Tensor,
                           face_features: torch.Tensor) -> torch.Tensor:
    """face_idx (B,H,W) int32 (-1 background), bary (B,H,W,3), face_features
    (B,F,3,C) -> (B,H,W,C) image-space interpolation, 0 on background."""
    B, H, W = face_idx.shape
    C = face_features.shape[-1]
    safe = face_idx.clamp(min=0).reshape(B, H * W).long()
    vals = torch.gather(face_features, 1, safe[:, :, None, None].expand(
        B, H * W, 3, C))  # (B, P, 3, C)
    w = bary.reshape(B, H * W, 3, 1).to(face_features.dtype)
    out = w[:, :, 0] * vals[:, :, 0] + w[:, :, 1] * vals[:, :, 1] \
        + w[:, :, 2] * vals[:, :, 2]
    out = out.reshape(B, H, W, C)
    return torch.where((face_idx >= 0)[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def rasterize(height: int, width: int, face_vertices_z: torch.Tensor,
              face_vertices_image: torch.Tensor, face_features: torch.Tensor,
              backend: Optional[str] = None, face_chunk: int = 128):
    """kaolin-compatible entry (kal.render.mesh.rasterize's arguments):
    face_vertices_z (B, F, 3), face_vertices_image (B, F, 3, 2) NDC,
    face_features (B, F, 3, C) -> (image_features (B, H, W, C), 0 on
    background; face_idx (B, H, W) int32, -1 on background).

    The port's backends, in place of the reference's "pallas"/"xla":
    "kernel" is K5 (raster/raster_kernel.py, CUDA tensors only; it raises
    on CPU tensors and never gives way to the plain version), "plain" is
    `rasterize_geometry` above (face_chunk faces a chunk) on any device,
    and None takes "kernel" for CUDA tensors and "plain" for CPU ones."""
    if backend is None:
        backend = "kernel" if face_vertices_z.is_cuda else "plain"
    if backend == "kernel":
        from contexture_nerf_tpu_torch.raster.raster_kernel import \
            rasterize_geometry_kernel
        face_idx, bary = rasterize_geometry_kernel(
            face_vertices_z, face_vertices_image, height, width)
    elif backend == "plain":
        face_idx, bary = rasterize_geometry(
            face_vertices_z, face_vertices_image, height, width,
            face_chunk=face_chunk)
    else:
        raise ValueError(f"no raster backend {backend!r}")
    return interpolate_attributes(face_idx, bary, face_features), face_idx
