"""GroupNorm(+SiLU), the plain path.

Counterpart of contexture_nerf_tpu/ops/groupnorm.py
`group_norm_silu_reference`, the path the reference takes by default
(`USE_PALLAS = False`). Its Pallas kernel (`_kernel`) is still to be ported.
Tensors here are NCHW; statistics are f32 over (C/groups, H, W) per group,
biased variance, then the affine, the optional SiLU and the cast.
"""

from __future__ import annotations

import torch


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, act: bool = True,
                    out_dtype=None) -> torch.Tensor:
    """x (B, C, ...) -> GroupNorm(x) * scale + bias, SiLU if act, cast to
    out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    B, C = x.shape[0], x.shape[1]
    xf = x.float().reshape(B, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if act:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype)


class GroupNormSiLU(torch.nn.Module):
    """GroupNorm -> SiLU -> cast as one op; act=False is plain GroupNorm +
    cast. Parameters `weight`/`bias` (flax `scale`/`bias`), kept f32."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 act: bool = True, out_dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.act, self.out_dtype = \
            groups, eps, act, out_dtype
        self.weight = torch.nn.Parameter(torch.ones(channels))
        self.bias = torch.nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.groups,
                               self.eps, self.act, self.out_dtype)
