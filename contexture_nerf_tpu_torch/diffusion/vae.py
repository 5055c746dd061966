"""AutoencoderKL (SD VAE) encoder and decoder, NCHW; counterpart of
contexture_nerf_tpu/diffusion/vae.py (`VAEConfig`, `Encoder`, `Decoder`,
`encode_moments`, `decode`, `sample_gaussian`). The SDS step uses the
encoder; the SD2-depth bootstrap decodes its final latent.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from contexture_nerf_tpu_torch.diffusion.layers import (Conv, Dense,
                                                        Downsample2D,
                                                        ResnetBlock2D,
                                                        Upsample2D)
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU


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
    def sd():
        return VAEConfig()

    @staticmethod
    def tiny():
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1)

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VAEAttention(nn.Module):
    """Single-head self-attention of the mid block (diffusers AttnBlock):
    plain matmul + softmax, as in the reference (not the flash kernel)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
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
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / \
            torch.sqrt(torch.tensor(float(C)))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        h = torch.matmul(attn, v)
        h = self.to_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
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
    """post_quant_conv, conv_in, a mid block (resnet, attention, resnet),
    layers_per_block + 1 resnets per up block (deepest first) with an
    Upsample2D after every block but the last, then GroupNorm+SiLU and
    conv_out."""

    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
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


def encode_moments(encoder: Encoder, images: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B,3,H,W) in [-1,1] -> (mean, logvar) each (B,latent,h,w),
    logvar clipped to [-30, 20]."""
    moments = encoder(images.to(encoder.dtype))
    mean, logvar = moments.chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def decode(decoder: Decoder, latents: torch.Tensor) -> torch.Tensor:
    """latents (B,latent,h,w) -> images (B,3,H,W) in about [-1, 1], in the
    decoder's dtype."""
    return decoder(latents.to(decoder.dtype))


def sample_gaussian(mean: torch.Tensor, logvar: torch.Tensor,
                    eps: torch.Tensor) -> torch.Tensor:
    """latent_dist.sample() with the normal draw `eps` given."""
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
