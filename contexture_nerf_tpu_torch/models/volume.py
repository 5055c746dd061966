"""NeRF volume rendering: rays, stratified sampling, hierarchical inverse-CDF
sampling and alpha compositing; counterpart of
contexture_nerf_tpu/models/volume.py (`get_rays`, `ndc_rays`,
`stratified_samples`, `sample_pdf`, `composite`, `volume_render`).

The random draws are tensors of uniforms in [0, 1): a caller (a test) may
pass the reference's; otherwise `volume_render` draws them from its
torch.Generator. Plain PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Per-pixel rays (H, W, 3) origins and directions from intrinsics K
    (3,3) and camera-to-world c2w (3,4): +x right, +y up, the camera looks
    down -z."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Rays moved to the near plane, then to normalized device
    coordinates."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def stratified_samples(near: float, far: float, n_rays: int,
                       n_samples: int, u: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """Depths along the rays, (n_rays, n_samples): evenly spaced from near
    to far, each moved within its stratum by the uniforms u
    (n_rays, n_samples) where given."""
    dev = u.device if u is not None else device
    t = torch.linspace(0.0, 1.0, n_samples, device=dev)
    z = (near * (1 - t) + far * t).expand(n_rays, n_samples)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant density `weights`
    (R, B-1) over the edges `bins` (R, B): (R, n_samples), at the uniforms
    u (R, n_samples), or at evenly spaced ones (det) where u is None."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device).expand(
            cdf.shape[:-1] + (n_samples,))
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def composite(raw_rgb: torch.Tensor, raw_sigma: torch.Tensor,
              z_vals: torch.Tensor, rays_d: torch.Tensor,
              white_bkgd: bool = False):
    """Alpha compositing of raw_rgb (R,S,3) (before the sigmoid) and
    raw_sigma (R,S) at depths z_vals (R,S) along rays_d (R,3). Returns
    (rgb (R,3), depth (R,), acc (R,), weights (R,S))."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw_rgb)
    alpha = 1.0 - torch.exp(-F.relu(raw_sigma) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map, weights


def volume_render(field_fn: Callable, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, near: float = 0.5, far: float = 2.5,
                  n_coarse: int = 64, n_fine: int = 0,
                  white_bkgd: bool = True,
                  u_coarse: Optional[torch.Tensor] = None,
                  u_fine: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """Coarse (and, with n_fine, hierarchical fine) volume render of a
    radiance field: field_fn(points (R,S,3)) -> (rgb_raw (R,S,3),
    sigma_raw (R,S)). The stratified draws u_coarse (R, n_coarse) and the
    fine pass's u_fine (R, n_fine) come from `generator` where not given.
    Returns rgb, depth, acc and weights of the last pass."""
    R, dev = rays_o.shape[0], rays_o.device
    if u_coarse is None:
        u_coarse = torch.rand((R, n_coarse), generator=generator, device=dev)
    if n_fine > 0 and u_fine is None:
        u_fine = torch.rand((R, n_fine), generator=generator, device=dev)
    z = stratified_samples(near, far, R, n_coarse, u_coarse.to(dev))
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    rgb_raw, sigma_raw = field_fn(pts)
    rgb, depth, acc, weights = composite(rgb_raw, sigma_raw, z, rays_d,
                                         white_bkgd)
    if n_fine > 0:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        z_fine = sample_pdf(mids, weights[:, 1:-1], n_fine, u_fine.to(dev))
        z_all = torch.sort(torch.cat([z, z_fine], -1), -1).values
        pts = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
        rgb_raw, sigma_raw = field_fn(pts)
        rgb, depth, acc, weights = composite(rgb_raw, sigma_raw, z_all,
                                             rays_d, white_bkgd)
    return {"rgb": rgb, "depth": depth, "acc": acc, "weights": weights}
