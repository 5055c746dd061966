"""Image-space utilities: the port's counterparts of
contexture_nerf_tpu/ops/image.py `get_view_direction`,
`get_nonzero_region_tuple`, `resize_bilinear` and `crop_and_resize`, and
the `jax.image.resize` methods the SD2-depth bootstrap uses (linear,
bicubic, nearest).

Bounding boxes are host-side integer math on fixed masks, computed once at
setup; the crops they give are static slices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_view_direction(thetas, phis, overhead, front):
    """Bin (theta, phi) into {front, left, back, right, top, bottom} =
    {0..5}. Host-side numpy; returns an int array."""
    thetas = np.atleast_1d(np.asarray(thetas, np.float64))
    phis = np.atleast_1d(np.asarray(phis, np.float64))
    res = np.zeros(thetas.shape[0], dtype=np.int64)
    res[(phis >= (2 * np.pi - front / 2)) & (phis < front / 2)] = 0
    res[(phis >= front / 2) & (phis < (np.pi - front / 2))] = 1
    res[(phis >= (np.pi - front / 2)) & (phis < (np.pi + front / 2))] = 2
    res[(phis >= (np.pi + front / 2)) & (phis < (2 * np.pi - front / 2))] = 3
    res[thetas <= overhead] = 4
    res[thetas >= (np.pi - overhead)] = 5
    return res


def get_nonzero_region_tuple(mask) -> Tuple[int, int, int, int]:
    """Square bbox with a 10% margin around the nonzero pixels of a (H, W)
    mask (a host array or a tensor). Returns (min_h, min_w, max_h, max_w)."""
    if torch.is_tensor(mask):
        mask = mask.detach().cpu().numpy()
    mask = np.asarray(mask)
    nz = np.nonzero(mask)
    min_h, max_h = int(nz[0].min()), int(nz[0].max())
    min_w, max_w = int(nz[1].min()), int(nz[1].max())
    size = max(max_h - min_h + 1, max_w - min_w + 1) * 1.1
    h_start = min_h - (size - (max_h - min_h + 1)) / 2
    w_start = min_w - (size - (max_w - min_w + 1)) / 2
    min_h = max(0, int(h_start))
    min_w = max(0, int(w_start))
    max_h = min(mask.shape[0], int(min_h + size))
    max_w = min(mask.shape[1], int(min_w + size))
    return min_h, min_w, max_h, max_w


def resize_linear(x: torch.Tensor, hw) -> torch.Tensor:
    """jax.image.resize(method="linear") on NCHW: half-pixel bilinear that
    antialiases when it downsamples (hence antialias=True), computed in
    f32."""
    y = F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


def resize_bicubic(x: torch.Tensor, hw) -> torch.Tensor:
    """jax.image.resize(method="bicubic") on NCHW: the Keys kernel with
    a = -0.5, half-pixel centres, weights over the in-bounds taps
    normalized, widened to antialias when it shrinks. torch's bicubic is
    that with antialias=True; without it, torch takes a = -0.75 and clamps
    at the border. Computed in f32."""
    y = F.interpolate(x.float(), size=tuple(hw), mode="bicubic",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """jax.image.resize(method="nearest") on NCHW: output i reads input
    floor((i + 0.5) * in / out), which is torch's "nearest-exact" (its
    "nearest" reads floor(i * in / out))."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


def crop_and_resize(x: torch.Tensor, bbox: Tuple[int, int, int, int],
                    out_h: int, out_w: int) -> torch.Tensor:
    """Crop (B, C, H, W) to the integer bbox and resize to (out_h, out_w)."""
    min_h, min_w, max_h, max_w = bbox
    return resize_linear(x[:, :, min_h:max_h, min_w:max_w], (out_h, out_w))
