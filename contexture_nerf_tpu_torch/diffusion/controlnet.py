"""Depth ControlNet, NCHW; counterpart of
contexture_nerf_tpu/diffusion/controlnet.py (`ControlNetCondEmbedding`,
`ControlNet`, `embed_cond`). The output heads (`controlnet_down_blocks_*`,
`controlnet_mid_block`) and the hint embedder's `conv_out` start at zero.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch.diffusion.layers import Conv
from contexture_nerf_tpu_torch.diffusion.unet import (UNetConfig,
                                                      build_down_path,
                                                      run_down_path)


def _zero_conv(cin, cout, k, padding=0):
    conv = Conv(cin, cout, k, padding=padding)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ControlNetCondEmbedding(nn.Module):
    """Pixel-space cond image -> latent-resolution feature: 16, 32, 96, 256
    conv stack with three stride-2 steps and a zero-initialized output."""

    def __init__(self, conditioning_embedding_channels: int,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.n = len(block_out_channels)
        self.conv_in = Conv(3, block_out_channels[0], 3, padding=1)
        for i in range(self.n - 1):
            setattr(self, f"blocks_{2 * i}",
                    Conv(block_out_channels[i], block_out_channels[i], 3,
                         padding=1))
            setattr(self, f"blocks_{2 * i + 1}",
                    Conv(block_out_channels[i], block_out_channels[i + 1], 3,
                         stride=2, padding=1))
        self.conv_out = _zero_conv(block_out_channels[-1],
                                   conditioning_embedding_channels, 3, 1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for i in range(self.n - 1):
            h = F.silu(getattr(self, f"blocks_{2 * i}")(h))
            h = F.silu(getattr(self, f"blocks_{2 * i + 1}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, config: UNetConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.controlnet_cond_embedding = ControlNetCondEmbedding(
            cfg.block_out_channels[0])
        res_ch = build_down_path(self, cfg, dtype)
        for i, ch in enumerate(res_ch):
            setattr(self, f"controlnet_down_blocks_{i}", _zero_conv(ch, ch, 1))
        self.n_res = len(res_ch)
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = _zero_conv(mid, mid, 1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                controlnet_cond, conditioning_scale: float = 1.0,
                cond_embedding: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample (B,C,h,w); controlnet_cond (B,3,8h,8w) pixel-space cond
        image, or its precomputed `cond_embedding` (B,C0,h,w). Returns the
        NCHW down residuals and the mid residual, times the scale."""
        if cond_embedding is None:
            cond_embedding = self.controlnet_cond_embedding(
                controlnet_cond.to(self.dtype))
        h, res_stack, _, _ = run_down_path(
            self, self.config, sample, timesteps, encoder_hidden_states,
            cond_embedding=cond_embedding)
        downs = [getattr(self, f"controlnet_down_blocks_{i}")(r)
                 * conditioning_scale for i, r in enumerate(res_stack)]
        return downs, self.controlnet_mid_block(h) * conditioning_scale


def embed_cond(controlnet: ControlNet, controlnet_cond: torch.Tensor
               ) -> torch.Tensor:
    """The hint embedder alone: (B,3,H,W) -> (B,C0,H/8,W/8) NCHW. The
    embedding depends only on the cond image, so the trainer computes it
    once and passes it back as `cond_embedding`."""
    return controlnet.controlnet_cond_embedding(
        controlnet_cond.to(controlnet.dtype))
