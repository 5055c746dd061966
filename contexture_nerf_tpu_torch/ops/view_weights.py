"""Cross-view face-visibility weights; the port's counterpart of
contexture_nerf_tpu/ops/view_weights.py `compute_view_weights`.

A pixel's weight is True when its face is seen most head-on (largest
camera-space z-normal) in this view among the views that see the face. The
value compared is constant per (view, face), so the reduction is over
(views, faces): a scatter-max of visibility, a max over views, a gather.
"""

from __future__ import annotations

import torch


def compute_view_weights(face_idx: torch.Tensor,
                         face_normals_z: torch.Tensor) -> torch.Tensor:
    """face_idx (B,1,H,W) int32 (-1 background); face_normals_z (B,F).
    Returns (B,1,H,W) bool; background pixels are True."""
    B, _, H, W = face_idx.shape
    F = face_normals_z.shape[1]
    fi = face_idx.reshape(B, H * W).long()
    valid = fi >= 0
    fi_safe = fi.clamp(min=0)
    vis = torch.zeros((B, F), dtype=torch.float32, device=fi.device)
    vis = vis.scatter_reduce(1, fi_safe, valid.float(), reduce="amax")
    neg_inf = torch.tensor(float("-inf"), dtype=face_normals_z.dtype,
                           device=fi.device)
    max_z_per_face = torch.where(vis > 0, face_normals_z, neg_inf).amax(0)
    per_pix_nz = torch.gather(face_normals_z, 1, fi_safe)
    per_pix_max = max_z_per_face[fi_safe]
    unworthy = (per_pix_nz < per_pix_max) & valid
    return (~unworthy).reshape(B, 1, H, W)
