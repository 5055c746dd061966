"""Texture sampling at per-pixel UVs; the port's counterpart of
contexture_nerf_tpu/ops/texture.py `sample_texture`: grid_sample semantics
with align_corners=False, zero padding and kaolin's v-flip, written as
explicit gathers in the reference's operation order.
"""

from __future__ import annotations

import torch


def sample_texture(uv: torch.Tensor, texture: torch.Tensor,
                   mode: str = "bilinear") -> torch.Tensor:
    """Sample `texture` (B|1, C, TH, TW) at `uv` (B, H, W, 2) in [0, 1].
    Returns (B, H, W, C); differentiable w.r.t. the texture."""
    B = uv.shape[0]
    _, C, TH, TW = texture.shape
    u, v = uv[..., 0], uv[..., 1]
    px = u * TW - 0.5  # grid_sample pixel coordinate of grid = 2u - 1
    py = (1.0 - v) * TH - 0.5  # v flipped
    tex_flat = texture.reshape(texture.shape[0], C, TH * TW).expand(
        B, C, TH * TW)

    def gather(iy, ix):
        lin = (iy.clamp(0, TH - 1) * TW + ix.clamp(0, TW - 1)).reshape(B, 1, -1)
        out = torch.gather(tex_flat, 2, lin.expand(B, C, lin.shape[-1]))
        out = out.permute(0, 2, 1).reshape(*iy.shape, C)
        inb = ((iy >= 0) & (iy < TH) & (ix >= 0) & (ix < TW))[..., None]
        return torch.where(inb, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))

    if mode == "nearest":
        return gather(torch.floor(py + 0.5).long(),
                      torch.floor(px + 0.5).long())
    if mode != "bilinear":
        raise NotImplementedError(f"texture interpolation mode {mode}")
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = x0 + 1, y0 + 1
    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy
