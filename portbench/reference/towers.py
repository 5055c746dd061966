"""Plain towers of the frozen reference: the SD2-family UNet with the
Zero123++ reference attention, the depth ControlNet, and the AutoencoderKL
encoder and decoder, NCHW. The published sizes are the defaults of
`UNetConfig` (sudo-ai/zero123plus-v1.1 unet/config.json: 320/640/1280/1280,
heads 5/10/20/20, cross-attention 1024) and `VAEConfig` (SD2's VAE:
128/256/512/512). Names follow the measured program's modules.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.layers import (Conv, Dense, Downsample2D,
                                        GroupNormSiLU, ResnetBlock2D,
                                        TimestepEmbedding, Transformer2DModel,
                                        Upsample2D, timestep_embedding)


class UNetConfig:
    def __init__(self, in_channels=4, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2, cross_attention_dim=1024,
                 num_heads=(5, 10, 20, 20), transformer_depth=1):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        self.num_heads = tuple(num_heads)
        self.transformer_depth = transformer_depth

    @staticmethod
    def tiny():
        return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=32, num_heads=(2, 4))

    def is_cross(self, bi: int) -> bool:
        return bi < len(self.block_out_channels) - 1


class VAEConfig:
    def __init__(self, in_channels=3, latent_channels=4,
                 block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, scaling_factor=0.18215):
        self.in_channels = in_channels
        self.latent_channels = latent_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.scaling_factor = scaling_factor

    @staticmethod
    def tiny():
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1)

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def _transformer(cfg: UNetConfig, bi: int, ch: int, dtype):
    heads = cfg.num_heads[bi]
    return Transformer2DModel(ch, heads, ch // heads, cfg.cross_attention_dim,
                              depth=cfg.transformer_depth, dtype=dtype)


def build_down_path(module: nn.Module, cfg: UNetConfig, dtype) -> List[int]:
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


def run_down_path(module, cfg: UNetConfig, sample, timesteps,
                  encoder_hidden_states, cond_embedding=None,
                  ref_kv_list=None, ref_out=None, mid_hook=None):
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

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_residuals: Optional[List[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                ref_kv_list: Optional[list] = None,
                ref_out: Optional[list] = None):
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


class ControlNetCondEmbedding(nn.Module):
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
        self.conv_out = Conv(block_out_channels[-1],
                             conditioning_embedding_channels, 3, padding=1)

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
            setattr(self, f"controlnet_down_blocks_{i}", Conv(ch, ch, 1))
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = Conv(mid, mid, 1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                cond_embedding, conditioning_scale: float = 1.0):
        h, res_stack, _, _ = run_down_path(
            self, self.config, sample, timesteps, encoder_hidden_states,
            cond_embedding=cond_embedding)
        downs = [getattr(self, f"controlnet_down_blocks_{i}")(r)
                 * conditioning_scale for i, r in enumerate(res_stack)]
        return downs, self.controlnet_mid_block(h) * conditioning_scale


class VAEAttention(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.group_norm = GroupNormSiLU(channels, 32, 1e-6, act=False,
                                        out_dtype=dtype)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out = Dense(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2))
                             / float(C) ** 0.5, dim=-1)
        h = self.to_out(torch.matmul(attn, v))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels[0]
        self.conv_in = Conv(cfg.in_channels, ch, 3, padding=1)
        for bi, out_ch in enumerate(cfg.block_out_channels):
            for li in range(cfg.layers_per_block):
                setattr(self, f"down_{bi}_resnet_{li}",
                        ResnetBlock2D(ch, out_ch, eps=1e-6, dtype=dtype))
                ch = out_ch
            if bi < len(cfg.block_out_channels) - 1:
                setattr(self, f"down_{bi}_downsample",
                        Downsample2D(out_ch, asymmetric=True))
        self.mid_resnet_0 = ResnetBlock2D(ch, ch, eps=1e-6, dtype=dtype)
        self.mid_attn = VAEAttention(ch, dtype)
        self.mid_resnet_1 = ResnetBlock2D(ch, ch, eps=1e-6, dtype=dtype)
        self.conv_norm_out = GroupNormSiLU(ch, 32, 1e-6, out_dtype=dtype)
        self.conv_out = Conv(ch, 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = Conv(2 * cfg.latent_channels,
                               2 * cfg.latent_channels, 1)

    def forward(self, x):
        cfg = self.config
        h = self.conv_in(x)
        for bi in range(len(cfg.block_out_channels)):
            for li in range(cfg.layers_per_block):
                h = getattr(self, f"down_{bi}_resnet_{li}")(h)
            if bi < len(cfg.block_out_channels) - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.quant_conv(self.conv_out(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        lat = cfg.latent_channels
        ch = cfg.block_out_channels[-1]
        self.post_quant_conv = Conv(lat, lat, 1)
        self.conv_in = Conv(lat, ch, 3, padding=1)
        self.mid_resnet_0 = ResnetBlock2D(ch, ch, eps=1e-6, dtype=dtype)
        self.mid_attn = VAEAttention(ch, dtype)
        self.mid_resnet_1 = ResnetBlock2D(ch, ch, eps=1e-6, dtype=dtype)
        for bi in reversed(range(len(cfg.block_out_channels))):
            out_ch = cfg.block_out_channels[bi]
            for li in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{bi}_resnet_{li}",
                        ResnetBlock2D(ch, out_ch, eps=1e-6, dtype=dtype))
                ch = out_ch
            if bi > 0:
                setattr(self, f"up_{bi}_upsample", Upsample2D(out_ch))
        self.conv_norm_out = GroupNormSiLU(ch, 32, 1e-6, out_dtype=dtype)
        self.conv_out = Conv(ch, cfg.in_channels, 3, padding=1)

    def forward(self, z):
        cfg = self.config
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for bi in reversed(range(len(cfg.block_out_channels))):
            for li in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{bi}_resnet_{li}")(h)
            if bi > 0:
                h = getattr(self, f"up_{bi}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))


def encode_moments(encoder: Encoder, images):
    """images in [-1, 1] -> (mean, logvar clipped to [-30, 20])."""
    mean, logvar = encoder(images).chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)
