"""DDPM noise schedule pieces the SDS step needs, and the DreamTime t
schedule.

Counterpart of contexture_nerf_tpu/diffusion/schedulers.py
(`make_alphas_cumprod`, `add_noise`, `velocity_target`,
`dreamtime_schedule`). SD's "scaled_linear" betas: linspace(sqrt(b0),
sqrt(b1), T)^2, with b0 = 0.00085, b1 = 0.012.
"""

from __future__ import annotations

import torch

from contexture_nerf_tpu_torch import resolve_device


def make_alphas_cumprod(device="cuda") -> torch.Tensor:
    """(1000,) f32 alphas_cumprod of the scaled-linear schedule. Computed in
    f32, as the reference is (JAX without x64 demotes its float64
    request)."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(resolve_device(device))


def _acp(alphas_cumprod, t, sample):
    t = torch.as_tensor(t, device=alphas_cumprod.device).long().reshape(-1)
    return alphas_cumprod[t].reshape((-1,) + (1,) * (sample.dim() - 1)).to(
        sample.dtype)


def add_noise(alphas_cumprod, sample, noise, t):
    """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * sample + torch.sqrt(1.0 - acp) * noise


def velocity_target(alphas_cumprod, sample, noise, t):
    """v = sqrt(acp) eps - sqrt(1 - acp) x_0."""
    acp = _acp(alphas_cumprod, t, sample)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample


def dreamtime_schedule(alphas_cumprod: torch.Tensor, total_iterations: int,
                       m: float = 500, s: float = 125) -> torch.Tensor:
    """DreamTime t(i) for i in [0, N), (N,) int64."""
    acp = alphas_cumprod.float().cpu()
    T = acp.shape[0]
    w_d = torch.sqrt(1 - acp)
    ts = torch.arange(T, dtype=torch.float32)
    w_p = torch.exp(-((ts - m) ** 2) / (2 * s ** 2))
    w = w_d * w_p
    w = w / w.sum()
    cumulative_survival = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    targets = torch.arange(total_iterations,
                           dtype=torch.float32) / total_iterations
    diffs = torch.abs(cumulative_survival[None, :] - targets[:, None])
    return torch.argmin(diffs, dim=1)
