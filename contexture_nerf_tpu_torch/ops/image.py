"""Image-space utilities: the port's counterparts of
contexture_nerf_tpu/ops/image.py `get_view_direction`,
`get_nonzero_region_tuple`, `resize_bilinear`, `crop_and_resize`,
`color_with_shade`, `save_colormap`, `tensor2numpy`, `pad_tensor_to_size`,
`gaussian_kernel_2d`, `gaussian_blur`, `smooth_image`,
`get_nonzero_region_vectorized`, `crop_img_to_bounding_box` and
`seed_everything`, the
`jax.image.resize` methods the SD2-depth bootstrap uses (linear, bicubic,
nearest), and `save_image`, which writes an image file with Pillow or,
where Pillow is missing, as PNG through the port's own encoder.

Bounding boxes are host-side integer math on fixed masks, computed once at
setup; the crops they give are static slices.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Tuple

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


def pad_tensor_to_size(x: torch.Tensor, target_h: int, target_w: int,
                       value: float = 1.0) -> torch.Tensor:
    """Centre-pad the last two dims to (target_h, target_w) with `value`,
    the odd pixel after (below, right)."""
    ph, pw = target_h - x.shape[-2], target_w - x.shape[-1]
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                 value=value)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The JAX package's resize_bilinear: jax.image.resize linear, which
    antialiases when it shrinks (resize_linear)."""
    return resize_linear(x, (out_h, out_w))


def gaussian_kernel_2d(kernlen: int, std: float) -> torch.Tensor:
    """(kernlen, kernlen) outer product of exp(-n^2 / 2 std^2), n centred."""
    n = torch.arange(kernlen, dtype=torch.float32) - (kernlen - 1.0) / 2.0
    w = torch.exp(-(n ** 2) / (2 * std * std))
    return torch.outer(w, w)


def gaussian_blur(image: torch.Tensor, kernel_size: int,
                  std: float) -> torch.Tensor:
    """Normalized Gaussian blur of (B,1,H,W), zero-padded to the same size."""
    k = gaussian_kernel_2d(kernel_size, std).to(image.device)
    k = (k / k.sum())[None, None].to(image.dtype)
    return F.conv2d(image, k, padding=kernel_size // 2)


def smooth_image(img: torch.Tensor, sigma: float,
                 kernel_size: int = 51) -> torch.Tensor:
    """Gaussian blur of each channel of a (C,H,W) image."""
    return gaussian_blur(img[:, None], kernel_size, sigma)[:, 0]


def get_nonzero_region_vectorized(masks) -> np.ndarray:
    """get_nonzero_region_tuple of each (H,W) mask of (B,H,W): (B,4) int64
    [min_h, min_w, max_h, max_w]."""
    return np.stack([np.asarray(get_nonzero_region_tuple(m), np.int64)
                     for m in masks])


def crop_img_to_bounding_box(img: torch.Tensor,
                             bounding_boxes) -> torch.Tensor:
    """Each image of (B,C,H,W) cropped to its box, top-left aligned in a
    (max_h, max_w) canvas of ones."""
    boxes = np.asarray(bounding_boxes)
    max_h = int((boxes[:, 2] - boxes[:, 0]).max())
    max_w = int((boxes[:, 3] - boxes[:, 1]).max())
    out = img.new_ones((img.shape[0], img.shape[1], max_h, max_w))
    for i, (min_h, min_w, mh, mw) in enumerate(boxes.tolist()):
        out[i, :, :mh - min_h, :mw - min_w] = img[i, :, min_h:mh, min_w:mw]
    return out


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the port's
    device draws come from explicit torch.Generators)."""
    import os
    import random

    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def color_with_shade(color: List[float], z_normals: torch.Tensor,
                     light_coef: float = 0.7) -> torch.Tensor:
    """A flat colour shaded by the z normal: color * (light_coef +
    (1 - light_coef) * z_normals), no gradient through the normals."""
    normals_with_light = light_coef + (1 - light_coef) * z_normals.detach()
    return torch.tensor(color, dtype=z_normals.dtype,
                        device=z_normals.device).reshape(1, 3, 1, 1) * \
        normals_with_light


def tensor2numpy(x) -> np.ndarray:
    """An image in [0, 1] -> uint8 by truncation, raising on NaN or Inf."""
    arr = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if np.any(np.isnan(arr)) or np.any(np.isinf(arr)):
        raise ValueError(
            "Tensor contains NaNs or infinite values, which cannot be "
            "converted to np.uint8.")
    return (arr * 255).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """A (H, W, 3|4) or (H, W) uint8 array as PNG bytes: 8-bit RGB, RGBA
    or gray, filter 0 on every row, zlib-compressed."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    ctype = {1: 0, 3: 2, 4: 6}[arr.shape[2] if arr.ndim == 3 else 1]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(arr: np.ndarray, path) -> Path:
    """Write a (H, W, 3) or (H, W) uint8 image. With Pillow, in the format
    of the file's suffix; without it, as PNG through `encode_png`, the
    suffix changed to .png (a JPEG cannot be written without Pillow).
    Returns the path written."""
    path = Path(path)
    try:
        from PIL import Image
    except ImportError:
        path = path.with_suffix(".png")
        path.write_bytes(encode_png(arr))
        return path
    Image.fromarray(np.ascontiguousarray(arr)).save(path)
    return path


GIF_LEVELS = (6, 7, 6)  # red, green, blue levels of the GIF palette


def gif_palette_indices(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H, W) uint8 indices into `gif_palette`:
    each channel rounded to the nearest of its GIF_LEVELS evenly spaced
    levels."""
    lr, lg, lb = GIF_LEVELS
    f = frames.astype(np.int32)
    q = [(f[..., c] * (n - 1) + 127) // 255
         for c, n in enumerate(GIF_LEVELS)]
    return (q[0] * (lg * lb) + q[1] * lb + q[2]).astype(np.uint8)


def gif_palette() -> List[int]:
    """The fixed 6 x 7 x 6 = 252-colour palette, flat [r, g, b, ...]."""
    lr, lg, lb = GIF_LEVELS
    return [v for r in range(lr) for g in range(lg) for b in range(lb)
            for v in (r * 255 // (lr - 1), g * 255 // (lg - 1),
                      b * 255 // (lb - 1))]


def save_gif(frames: np.ndarray, path, fps: int = 25) -> None:
    """Frames (T, H, W, 3) uint8 as a looping GIF, with Pillow, every frame
    on one fixed 252-colour palette (`gif_palette_indices`): Pillow then
    only LZW-encodes, where an adaptive palette per frame costs it a
    quantisation of each frame (~0.4 s a 1024^2 frame on one core)."""
    from PIL import Image

    pal = gif_palette()
    ims = []
    for idx in gif_palette_indices(np.asarray(frames)):
        im = Image.fromarray(idx, mode="P")
        im.putpalette(pal)
        ims.append(im)
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(round(1000 / fps)), loop=0, optimize=False)


def save_colormap(arr: np.ndarray, path) -> None:
    """Save a (H,W) scalar map through the seismic colormap; a grayscale
    image where matplotlib is unavailable."""
    arr = np.asarray(arr, np.float32)
    try:
        from matplotlib import cm

        rgb = (cm.seismic(arr)[:, :, :3] * 255).astype(np.uint8)
    except ImportError:
        g = np.clip(arr, 0.0, 1.0)
        rgb = np.stack([(g * 255).astype(np.uint8)] * 3, axis=-1)
    save_image(rgb, path)
