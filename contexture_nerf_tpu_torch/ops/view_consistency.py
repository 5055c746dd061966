"""Cross-view colour consistency: the port's counterpart of
contexture_nerf_tpu/ops/view_consistency.py `compute_view_consistency`.

For every pixel of view i whose face has a vertex visible in view j, its
colour is compared with view j's colour at that vertex's projected pixel;
the result is the mean similarity 1 - |dRGB|/C over such pairs (i != j).
"""

from __future__ import annotations

from typing import Optional

import torch


def compute_view_consistency(rendered_views: torch.Tensor,
                             faces: torch.Tensor,
                             face_idx: torch.Tensor,
                             face_vertices_image: torch.Tensor,
                             n_vertices: Optional[int] = None
                             ) -> torch.Tensor:
    """rendered_views (V,C,H,W), faces (F,3), face_idx (V,H,W),
    face_vertices_image (V,F,3,2) NDC. Returns the scalar mean similarity
    (0 when no pixel pairs up)."""
    V, C, H, W = rendered_views.shape
    dev = rendered_views.device
    faces = faces.long()
    N = int(faces.max()) + 1 if n_vertices is None else int(n_vertices)
    flat_faces = faces.reshape(-1)  # (3F,)

    # vertex -> pixel (y, x) per view. A vertex listed by several faces is
    # written once per face, each time with the same value: it is projected
    # once and gathered per face (raster/camera.prepare_vertices), so the
    # duplicates of an index carry equal (y, x) and index_put_ without
    # accumulation is deterministic here whichever write lands last.
    coords = (face_vertices_image.reshape(V, -1, 2) + 1.0) / 2.0
    px = (coords[..., 0] * W).to(torch.int32)  # truncation, as astype
    py = (coords[..., 1] * H).to(torch.int32)
    vert_px = torch.full((V, N, 2), -1, dtype=torch.int32, device=dev)
    vert_px[:, flat_faces] = torch.stack([py, px], dim=-1)

    # vertex visibility per view: a max over the pixels that show it
    valid = face_idx >= 0  # (V,H,W)
    safe_f = face_idx.clamp(min=0).long()
    pix_verts = faces[safe_f]  # (V,H,W,3)
    vis = torch.zeros((V, N), dtype=torch.float32, device=dev)
    vis = vis.scatter_reduce(
        1, pix_verts.reshape(V, -1),
        valid.reshape(V, -1).repeat_interleave(3, dim=1).float(), "amax")

    # status[j, i, h, w, k]: is vertex k of view i's pixel visible in view j
    status = vis[:, pix_verts]  # (Vj, Vi, H, W, 3)
    has_shared = (status > 0).any(-1) & valid[None]  # (Vj, Vi, H, W)
    first = torch.argmax(status, dim=-1)  # the first maximal vertex
    rep_vert = torch.gather(pix_verts[None].expand(status.shape), -1,
                            first[..., None])[..., 0]  # (Vj,Vi,H,W)

    vj = torch.arange(V, device=dev)[:, None, None, None]
    src_yx = vert_px[vj, rep_vert].long()  # (Vj,Vi,H,W,2)
    sy = src_yx[..., 0].clamp(0, H - 1)
    sx = src_yx[..., 1].clamp(0, W - 1)
    in_bounds = ((src_yx[..., 0] >= 0) & (src_yx[..., 0] < H)
                 & (src_yx[..., 1] >= 0) & (src_yx[..., 1] < W))

    imgs = rendered_views.permute(0, 2, 3, 1)  # (V,H,W,C)
    gathered = imgs[vj, sy, sx]  # (Vj,Vi,H,W,C)
    target = imgs[None].expand(gathered.shape)

    sim = 1.0 - (target - gathered).abs().sum(-1) / C  # (Vj,Vi,H,W)
    offdiag = ~torch.eye(V, dtype=torch.bool, device=dev)[:, :, None, None]
    mask = has_shared & in_bounds & offdiag
    total = torch.where(mask, sim, torch.zeros((), device=dev)).sum()
    n = mask.sum()
    return torch.where(n > 0, total / n.clamp(min=1),
                       torch.zeros((), device=dev))
