"""The rasterizer kernel (K5, csrc/raster.cu) and its dispatch.

Counterpart of contexture_nerf_tpu/raster/pallas_raster.py
(`_raster_kernel`, `rasterize_geometry_pallas`). The TPU kernel Morton-sorts
faces and sweeps 8x128 pixel tiles against 128-face lane chunks; this one
needs neither: a CTA owns a 16x16 pixel tile, streams the faces' bounding
boxes in chunks of 256, keeps the faces whose box meets the tile (in face
order) and tests its pixels against their setup records in shared memory,
keeping the best (z, face, barycentrics) in registers. Face setup, bounding
boxes and the pixel-centre coordinates are plain torch ops around the
launch, as the reference computes them in XLA outside its kernel.

The kernel repeats the plain version's arithmetic (raster/rasterize.py)
operation for operation without FMA contraction, and breaks z ties by the
lowest face index, so the two agree bit for bit; `raster_agreement` states
the tie- and edge-tolerant check that chip_smoke.py and the card tests hold
them to all the same.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.raster.rasterize import (EPS, face_edge_setup,
                                                        pixel_centers)
from contexture_nerf_tpu_torch.raster.rasterize import \
    rasterize_geometry as rasterize_geometry_plain

REC = 16  # floats per face record
# the box a face is culled by is widened by this share of its largest NDC
# coordinate (plus the same absolute amount): far above the rounding of the
# edge functions, so culling never drops a face that a pixel tests inside
BOX_PAD = 1e-4

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("raster")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_fwd.argtypes = [p, p, p, p, i, i, i, i, p, p, p]
        lib.raster_fwd.restype = i
        _LIB = lib
    return _LIB


def face_records(face_vertices_z: torch.Tensor,
                 face_vertices_image: torch.Tensor):
    """The kernel's inputs: records (B, F, 16) f32 = [a0 a1 a2 b0 b1 b2
    c0 c1 c2 den z0 z1 z2 0 0 0] and boxes (B, F, 4) f32 = [xmin xmax ymin
    ymax], padded by BOX_PAD; a degenerate face (|den| <= 1e-12) gets an
    empty box (+inf, -inf, +inf, -inf) and is never tested."""
    fvi = face_vertices_image.float()
    ca, cb, cc, den = face_edge_setup(fvi)
    z = face_vertices_z.float()
    pad = torch.zeros_like(z)
    rec = torch.cat([ca, cb, cc, den[..., None], z, pad], dim=-1)
    fx, fy = fvi[..., 0], fvi[..., 1]
    m = BOX_PAD * (1.0 + fvi.abs().amax(dim=(-1, -2)))
    box = torch.stack([fx.amin(-1) - m, fx.amax(-1) + m,
                       fy.amin(-1) - m, fy.amax(-1) + m], dim=-1)
    inf = float("inf")
    empty = torch.tensor([inf, -inf, inf, -inf], device=box.device)
    box = torch.where((den.abs() > EPS)[..., None], box, empty)
    return rec.contiguous(), box.contiguous()


def rasterize_geometry_kernel(face_vertices_z: torch.Tensor,
                              face_vertices_image: torch.Tensor,
                              height: int, width: int):
    """K5 on the card: (face_idx (B,H,W) int32, -1 for background;
    bary (B,H,W,3) f32). All B views in one launch."""
    if not face_vertices_z.is_cuda or \
            face_vertices_image.device != face_vertices_z.device:
        raise ValueError("rasterize_geometry_kernel takes CUDA tensors on "
                         "one device")
    B, F = face_vertices_z.shape[:2]
    if face_vertices_z.shape != (B, F, 3) or \
            face_vertices_image.shape != (B, F, 3, 2):
        raise ValueError("expected face_vertices_z (B, F, 3) and "
                         "face_vertices_image (B, F, 3, 2); got "
                         f"{tuple(face_vertices_z.shape)} and "
                         f"{tuple(face_vertices_image.shape)}")
    if F == 0 or height <= 0 or width <= 0 or B > 65535:
        raise ValueError(f"nothing to rasterize: B={B} F={F} "
                         f"{height}x{width}")
    dev = face_vertices_z.device
    rec, box = face_records(face_vertices_z, face_vertices_image)
    ys, xs = pixel_centers(height, width, dev)
    face_idx = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((B, height, width, 3), dtype=torch.float32,
                       device=dev)
    err = _lib().raster_fwd(box.data_ptr(), rec.data_ptr(), xs.data_ptr(),
                            ys.data_ptr(), B, F, height, width,
                            face_idx.data_ptr(), bary.data_ptr(),
                            _build.stream_ptr(dev))
    _build.check(err, "raster_fwd")
    _build.launch_counts["raster"] += 1
    return face_idx, bary


def rasterize_geometry(face_vertices_z: torch.Tensor,
                       face_vertices_image: torch.Tensor,
                       height: int, width: int):
    """Visibility pass: the kernel for CUDA tensors, the plain version for
    CPU tensors (64-face chunks, as the reference renderer's XLA path)."""
    if face_vertices_z.is_cuda:
        return rasterize_geometry_kernel(face_vertices_z, face_vertices_image,
                                         height, width)
    if face_vertices_z.device.type != "cpu":
        raise ValueError(f"unsupported device {face_vertices_z.device}")
    return rasterize_geometry_plain(face_vertices_z, face_vertices_image,
                                    height, width, face_chunk=64)


def interpolated_z(face_idx, bary, face_vertices_z):
    """Camera-space z of each pixel's face at the pixel ((w0 z0 + w1 z1) +
    w2 z2), -inf on background."""
    B = face_idx.shape[0]
    safe = face_idx.clamp(min=0).reshape(B, -1).long()
    zz = torch.gather(face_vertices_z.float(), 1,
                      safe[..., None].expand(-1, -1, 3))
    w = bary.reshape(B, -1, 3)
    z = w[..., 0] * zz[..., 0] + w[..., 1] * zz[..., 1] + w[..., 2] * zz[..., 2]
    z = torch.where(face_idx.reshape(B, -1) >= 0, z,
                    torch.tensor(float("-inf"), device=z.device))
    return z.reshape(face_idx.shape)


def raster_agreement(idx, bary, idx_ref, bary_ref, face_vertices_z,
                     z_tie: float = 1e-6, edge: float = 1e-5) -> dict:
    """How a rasterization (idx, bary) agrees with a reference one on the
    same faces. Covered pixels are those either one covers. A pixel whose
    face differs is explained when both hit faces at z within z_tie of each
    other (a z tie), or when either hit lies on an edge of its face (min
    barycentric <= edge). Returns counts, the agreeing share of covered
    pixels, the unexplained mismatches and the max |bary - bary_ref| where
    the faces agree."""
    covered = (idx >= 0) | (idx_ref >= 0)
    same = idx == idx_ref
    mism = covered & ~same
    z = interpolated_z(idx, bary, face_vertices_z)
    z_ref = interpolated_z(idx_ref, bary_ref, face_vertices_z)
    both = (idx >= 0) & (idx_ref >= 0)
    tie = both & ((z - z_ref).abs() <= z_tie)
    on_edge = ((idx >= 0) & (bary.amin(-1) <= edge)) | \
        ((idx_ref >= 0) & (bary_ref.amin(-1) <= edge))
    n_cov = int(covered.sum())
    agree_hit = same & (idx >= 0)
    bary_err = float((bary - bary_ref).abs().amax(-1)[agree_hit].max()) \
        if bool(agree_hit.any()) else 0.0
    return {"covered": n_cov, "mismatch": int(mism.sum()),
            "agree": 1.0 - int(mism.sum()) / max(n_cov, 1),
            "unexplained": int((mism & ~tie & ~on_edge).sum()),
            "bary_err": bary_err}


def agreement_ok(a: dict, min_agree: float = 0.9999,
                 bary_tol: float = 1e-5) -> bool:
    """The limits K5 is held to against its plain version: face_idx equal
    on at least 99.99% of covered pixels, every mismatch a z tie or an edge
    pixel, and bary within 1e-5 where the faces agree."""
    return (a["agree"] >= min_agree and a["unexplained"] == 0
            and a["bary_err"] <= bary_tol)
