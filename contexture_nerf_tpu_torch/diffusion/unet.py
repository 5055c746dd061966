"""UNet2DCondition (SD2 / Zero123++ denoiser), NCHW; counterpart of
contexture_nerf_tpu/diffusion/unet.py. `ref_out` / `ref_kv_list` carry the
Zero123++ reference attention; `down_residuals` / `mid_residual` take the
ControlNet's (NCHW) injections.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from contexture_nerf_tpu_torch.diffusion.layers import (Conv, Downsample2D,
                                                        ResnetBlock2D,
                                                        TimestepEmbedding,
                                                        Transformer2DModel,
                                                        Upsample2D,
                                                        timestep_embedding)
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU


class UNetConfig:
    """SD2-family UNet hyperparameters."""

    def __init__(self, in_channels=4, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2,
                 cross_attention_dim=1024,
                 num_heads=(5, 10, 20, 20),
                 transformer_depth=1):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        self.num_heads = tuple(num_heads)
        self.transformer_depth = transformer_depth

    @staticmethod
    def zero123plus():
        return UNetConfig(in_channels=4)

    @staticmethod
    def tiny(in_channels=4, cross_attention_dim=32):
        return UNetConfig(in_channels=in_channels, out_channels=4,
                          block_out_channels=(32, 64),
                          layers_per_block=1,
                          cross_attention_dim=cross_attention_dim,
                          num_heads=(2, 4))

    def is_cross(self, bi: int) -> bool:
        return bi < len(self.block_out_channels) - 1


def _transformer(cfg: UNetConfig, bi: int, ch: int, dtype):
    heads = cfg.num_heads[bi]
    return Transformer2DModel(ch, heads, ch // heads,
                              cfg.cross_attention_dim,
                              depth=cfg.transformer_depth, dtype=dtype)


def build_down_path(module: nn.Module, cfg: UNetConfig, dtype) -> List[int]:
    """conv_in, time_embedding and the down/mid blocks shared by the UNet
    and the ControlNet; returns the channels of each residual it stacks."""
    c0 = cfg.block_out_channels[0]
    module.time_embedding = TimestepEmbedding(c0, c0 * 4)
    module.conv_in = Conv(cfg.in_channels, c0, 3, padding=1)
    ch, res_ch = c0, [c0]
    nb = len(cfg.block_out_channels)
    for bi, out_ch in enumerate(cfg.block_out_channels):
        for li in range(cfg.layers_per_block):
            setattr(module, f"down_{bi}_resnet_{li}",
                    ResnetBlock2D(ch, out_ch, temb_dim=c0 * 4, dtype=dtype))
            ch = out_ch
            if cfg.is_cross(bi):
                setattr(module, f"down_{bi}_attn_{li}",
                        _transformer(cfg, bi, out_ch, dtype))
            res_ch.append(out_ch)
        if bi < nb - 1:
            setattr(module, f"down_{bi}_downsample", Downsample2D(out_ch))
            res_ch.append(out_ch)
    mid = cfg.block_out_channels[-1]
    module.mid_resnet_0 = ResnetBlock2D(mid, mid, temb_dim=c0 * 4, dtype=dtype)
    module.mid_attn = _transformer(cfg, nb - 1, mid, dtype)
    module.mid_resnet_1 = ResnetBlock2D(mid, mid, temb_dim=c0 * 4, dtype=dtype)
    return res_ch


def run_down_path(module: nn.Module, cfg: UNetConfig, sample, timesteps,
                  encoder_hidden_states, cond_embedding=None,
                  ref_kv_list=None, ref_out=None, mid_hook=None):
    """Shared down + mid pass. Returns (h, res_stack, temb, context);
    mid_hook(res_stack) runs between the down and the mid blocks (the
    UNet adds the ControlNet residuals there)."""
    dtype = module.conv_in.weight.dtype
    x = sample.to(dtype)
    B = x.shape[0]
    t = torch.as_tensor(timesteps, device=x.device).reshape(-1).expand(B)
    temb = module.time_embedding(
        timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))
    context = encoder_hidden_states.to(dtype)
    h = module.conv_in(x)
    if cond_embedding is not None:
        h = h + cond_embedding.to(h.dtype)
    res_stack = [h]
    nb = len(cfg.block_out_channels)
    for bi in range(nb):
        for li in range(cfg.layers_per_block):
            h = getattr(module, f"down_{bi}_resnet_{li}")(h, temb)
            if cfg.is_cross(bi):
                h = getattr(module, f"down_{bi}_attn_{li}")(
                    h, context, ref_kv_list=ref_kv_list, ref_out=ref_out)
            res_stack.append(h)
        if bi < nb - 1:
            h = getattr(module, f"down_{bi}_downsample")(h)
            res_stack.append(h)
    if mid_hook is not None:
        res_stack = mid_hook(res_stack)
    h = module.mid_resnet_0(h, temb)
    h = module.mid_attn(h, context, ref_kv_list=ref_kv_list, ref_out=ref_out)
    h = module.mid_resnet_1(h, temb)
    return h, res_stack, temb, context


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        res_ch = build_down_path(self, cfg, dtype)
        ch = cfg.block_out_channels[-1]
        for bi in reversed(range(len(cfg.block_out_channels))):
            out_ch = cfg.block_out_channels[bi]
            for li in range(cfg.layers_per_block + 1):
                skip = res_ch.pop()
                setattr(self, f"up_{bi}_resnet_{li}", ResnetBlock2D(
                    ch + skip, out_ch, temb_dim=cfg.block_out_channels[0] * 4,
                    dtype=dtype))
                ch = out_ch
                if cfg.is_cross(bi):
                    setattr(self, f"up_{bi}_attn_{li}",
                            _transformer(cfg, bi, out_ch, dtype))
            if bi > 0:
                setattr(self, f"up_{bi}_upsample", Upsample2D(out_ch))
        c0 = cfg.block_out_channels[0]
        self.conv_norm_out = GroupNormSiLU(c0, 32, 1e-5, out_dtype=dtype)
        self.conv_out = Conv(c0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                down_residuals: Optional[List[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                ref_kv_list: Optional[list] = None,
                ref_out: Optional[list] = None):
        """sample (B, C, H, W); timesteps (B,) or (1,); encoder_hidden_states
        (B, S, cross_dim). Returns (B, out_C, H, W) in the tower dtype."""
        cfg = self.config

        def add_residuals(res_stack):
            if down_residuals is None:
                return res_stack
            return [r + d.to(r.dtype) for r, d in zip(res_stack,
                                                       down_residuals)]

        h, res_stack, temb, context = run_down_path(
            self, cfg, sample, timesteps, encoder_hidden_states,
            ref_kv_list=ref_kv_list, ref_out=ref_out, mid_hook=add_residuals)
        if mid_residual is not None:
            h = h + mid_residual.to(h.dtype)
        for bi in reversed(range(len(cfg.block_out_channels))):
            for li in range(cfg.layers_per_block + 1):
                h = torch.cat([h, res_stack.pop().to(h.dtype)], dim=1)
                h = getattr(self, f"up_{bi}_resnet_{li}")(h, temb)
                if cfg.is_cross(bi):
                    h = getattr(self, f"up_{bi}_attn_{li}")(
                        h, context, ref_kv_list=ref_kv_list, ref_out=ref_out)
            if bi > 0:
                h = getattr(self, f"up_{bi}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))
