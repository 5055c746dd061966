"""The rasterizer kernel (K5, csrc/raster.cu) and its dispatch.

Counterpart of contexture_nerf_tpu/raster/pallas_raster.py
(`_raster_kernel`, `rasterize_geometry_pallas`). The TPU kernel Morton-sorts
faces and sweeps 8x128 pixel tiles against 128-face lane chunks; this one
needs neither. A setup kernel (one thread per view and face) writes each
face's record and its conservative range of pixels; the faces are binned
to 16x16 tiles (a count per tile, an exclusive scan, a scatter into each
tile's slots); then a CTA owns one tile, stages only its list's records
and pixel ranges in shared memory and tests its pixels against them,
keeping the best (z, face, barycentrics) in registers. Each warp tests
only the faces whose pixel range meets its 8x4 block. Only tiles with a
face run; the outputs are filled with background beforehand.

The kernels repeat the plain version's arithmetic (raster/rasterize.py)
operation for operation without FMA contraction, and break z ties by the
lowest face index, so the two agree bit for bit; `raster_agreement` states
the tie- and edge-tolerant check that chip_smoke.py and the card tests hold
them to all the same. `face_records` is the setup's plain version (with
`pixel_ranges` and `tile_ranges`): the kernels mirror their arithmetic,
and the CPU tests reach it through them.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.raster.rasterize import (EPS, face_edge_setup,
                                                        pixel_centers)
from contexture_nerf_tpu_torch.raster.rasterize import \
    rasterize_geometry as rasterize_geometry_plain

REC = 16  # floats per face record
TILE = 16  # pixels a side of the kernels' tiles
# the box a face is culled by is widened by this share of its largest NDC
# coordinate (plus the same absolute amount): far above the rounding of the
# edge functions, so culling never drops a face that a pixel tests inside
BOX_PAD = 1e-4
SCAN_STEP = 4096  # tile counts a CTA of the scan (csrc/raster.cu)
EMPTY_RANGE = (0, -1, 0, -1)  # the pixel or tile range of a face with none

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("raster")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_setup.argtypes = [p, p, i, i, i, p, p, p, p]
        lib.raster_bin.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p]
        lib.raster_draw.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, i, p,
                                    p, p]
        for fn in (lib.raster_setup, lib.raster_bin, lib.raster_draw):
            fn.restype = i
        _LIB = lib
    return _LIB


def face_records(face_vertices_z: torch.Tensor,
                 face_vertices_image: torch.Tensor):
    """The setup's plain version: records (B, F, 16) f32 = [a0 a1 a2 b0 b1
    b2 c0 c1 c2 den z0 z1 z2 0 0 0] and boxes (B, F, 4) f32 = [xmin xmax
    ymin ymax], padded by BOX_PAD; a degenerate face (|den| <= 1e-12) gets
    an empty box (+inf, -inf, +inf, -inf)."""
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


def _pixel_coord(lo: torch.Tensor, n: int) -> torch.Tensor:
    """(lo + 1) * (n / 2) - 0.5 in f32, clamped to [-1, n]: the pixel index
    (as a float) whose centre sits at NDC lo, where centre i is at
    (i + 0.5) / n * 2 - 1."""
    return ((lo + 1.0) * (0.5 * n) - 0.5).clamp(-1.0, float(n))


def pixel_ranges(box: torch.Tensor, height: int, width: int):
    """The conservative range of pixels each face's padded box
    (`face_records`) can reach: (B, F, 4) int32 [ix0 ix1 iy0 iy1],
    inclusive; EMPTY_RANGE for a face off the frame, degenerate (its box is
    empty) or with a non-finite box. Every pixel whose centre lies in the
    box is in the range: the low edge is floored and the high edge ceiled
    in pixel units (a margin of up to one pixel over the f32 rounding of
    the centres), then clamped to the frame. The setup kernel repeats this
    arithmetic operation for operation; no float is converted to an int
    before it is clamped and known to be finite."""
    ok = torch.isfinite(box).all(-1)
    box = torch.where(ok[..., None], box, torch.zeros_like(box))
    ix0 = _pixel_coord(box[..., 0], width).floor().to(torch.int32).clamp(
        min=0)
    ix1 = _pixel_coord(box[..., 1], width).ceil().to(torch.int32).clamp(
        max=width - 1)
    # rows run down the frame: y = 1 - (iy + 0.5) / H * 2
    iy0 = _pixel_coord(-box[..., 3], height).floor().to(torch.int32).clamp(
        min=0)
    iy1 = _pixel_coord(-box[..., 2], height).ceil().to(torch.int32).clamp(
        max=height - 1)
    ok = ok & (ix0 <= ix1) & (iy0 <= iy1)
    empty = torch.tensor(EMPTY_RANGE, dtype=torch.int32, device=box.device)
    return torch.where(ok[..., None], torch.stack([ix0, ix1, iy0, iy1], -1),
                       empty).contiguous()


def tile_ranges(box: torch.Tensor, height: int, width: int):
    """The TILE x TILE tiles of each face's pixel range: (B, F, 4) int32
    [tx0 tx1 ty0 ty1], inclusive (EMPTY_RANGE stays empty)."""
    return torch.div(pixel_ranges(box, height, width), TILE,
                     rounding_mode="floor")


def range_tiles(ranges: torch.Tensor) -> torch.Tensor:
    """How many tiles each range covers (0 for EMPTY_RANGE)."""
    return ((ranges[..., 1] - ranges[..., 0] + 1)
            * (ranges[..., 3] - ranges[..., 2] + 1)).to(torch.int32)


def _check_faces(face_vertices_z, face_vertices_image, height, width):
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
    if B * F >= 2 ** 31:
        raise ValueError(f"{B} x {F} faces exceed the int32 face count")
    return B, F


def face_setup(face_vertices_z: torch.Tensor,
               face_vertices_image: torch.Tensor, height: int, width: int):
    """K5's setup for a height x width frame: (records (B, F, 16) f32,
    pixel ranges (B, F, 4) int32, tiles covered (B, F) int32). CUDA tensors
    run the setup kernel, CPU tensors its plain version (`face_records`,
    `pixel_ranges`)."""
    if not face_vertices_z.is_cuda:
        if face_vertices_z.device.type != "cpu":
            raise ValueError(f"unsupported device {face_vertices_z.device}")
        rec, box = face_records(face_vertices_z, face_vertices_image)
        ranges = pixel_ranges(box, height, width)
        return rec, ranges, range_tiles(
            torch.div(ranges, TILE, rounding_mode="floor"))
    if face_vertices_image.device != face_vertices_z.device:
        raise ValueError("face_setup takes tensors on one device")
    B, F = _check_faces(face_vertices_z, face_vertices_image, height, width)
    dev = face_vertices_z.device
    fvz = face_vertices_z.float().contiguous()
    fvi = face_vertices_image.float().contiguous()
    rec = torch.empty((B, F, REC), dtype=torch.float32, device=dev)
    ranges = torch.empty((B, F, 4), dtype=torch.int32, device=dev)
    ntiles = torch.empty((B, F), dtype=torch.int32, device=dev)
    err = _lib().raster_setup(fvz.data_ptr(), fvi.data_ptr(), B * F, height,
                              width, rec.data_ptr(), ranges.data_ptr(),
                              ntiles.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "raster_setup")
    return rec, ranges, ntiles


@functools.lru_cache(maxsize=16)
def _centres(height: int, width: int, device: torch.device):
    """pixel_centers on the card, made once per frame size (read only)."""
    return pixel_centers(height, width, device)


def rasterize_geometry_kernel(face_vertices_z: torch.Tensor,
                              face_vertices_image: torch.Tensor,
                              height: int, width: int):
    """K5 on the card: (face_idx (B,H,W) int32, -1 for background;
    bary (B,H,W,3) f32). All B views in one call: setup, the outputs
    filled with background, binning (count, scan; one host read of the
    list total and the busy tiles; scatter) and the tile pass over the
    busy tiles."""
    if not face_vertices_z.is_cuda or \
            face_vertices_image.device != face_vertices_z.device:
        raise ValueError("rasterize_geometry_kernel takes CUDA tensors on "
                         "one device")
    B, F = _check_faces(face_vertices_z, face_vertices_image, height, width)
    dev = face_vertices_z.device
    rec, ranges, _ = face_setup(face_vertices_z, face_vertices_image, height,
                                width)
    n_tiles = B * -(-height // TILE) * -(-width // TILE)
    cnt = torch.empty(-(-n_tiles // 4) * 4, dtype=torch.int32, device=dev)
    busy = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    off = torch.empty(n_tiles + 2, dtype=torch.int64, device=dev)
    part = torch.empty(2 * -(-n_tiles // SCAN_STEP), dtype=torch.int64,
                       device=dev)  # the scan's CTA sums
    ys, xs = _centres(height, width, dev)
    face_idx = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((B, height, width, 3), dtype=torch.float32,
                       device=dev)
    stream = _build.stream_ptr(dev)
    lib = _lib()
    _build.check(lib.raster_bin(
        ranges.data_ptr(), B, F, height, width, cnt.data_ptr(),
        part.data_ptr(), off.data_ptr(), busy.data_ptr(),
        face_idx.data_ptr(), bary.data_ptr(), stream), "raster_bin")
    # the list total and the busy tiles: the call's one host read
    total, n_busy = off[-2:].tolist()
    faces = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
    err = lib.raster_draw(ranges.data_ptr(), rec.data_ptr(), off.data_ptr(),
                          cnt.data_ptr(), faces.data_ptr(), busy.data_ptr(),
                          n_busy, xs.data_ptr(), ys.data_ptr(), B, F, height,
                          width, face_idx.data_ptr(), bary.data_ptr(), stream)
    _build.check(err, "raster_draw")
    _build.count_launch("raster", B, height, width, F)
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
