"""The spatio-temporal video UNet of SV3D_p (Stability AI's image-to-orbit
model; `sgm.modules.diffusionmodules.video_model.VideoUNet` under the
`network_config` of generative-models' `scripts/sampling/configs/sv3d_p.yaml`),
NCHW with the frames stacked on the batch axis: (B T, C, h, w).

Every level has the SD2 UNet's layers (diffusion/layers.py), each paired
with a temporal half and mixed with it by a learned `AlphaBlender`:

  - `VideoResBlock`: the spatial ResnetBlock2D `s`, then `time_stack`, a
    ResBlock over (B, C, T, h w) whose convolutions are (3, 1, 1) over the
    frames (GroupNorm statistics over C/32 channels of all T frames), with
    the frame's embedding added between them; out = a s + (1 - a) r with
    r = s + time_stack(s) and a = sigmoid(mix_factor). The port computes
    it as s + (1 - a) time_stack(s), the same sum, in the activations'
    dtype as sgm does.
  - `SpatialVideoTransformer`: GroupNorm and proj_in, the spatial
    BasicTransformerBlock over each frame's h w tokens, then
    `time_stack_0`, a `VideoTransformerBlock` over the T frames at every
    position (GEGLU ff_in, self-attention over the frames, cross-attention
    to the first frame's context, GEGLU ff; LayerNorms eps 1e-5) of the
    tokens plus the frame index's embedding (`time_pos_embed`, an MLP
    c -> 4c -> c over the sinusoid of 0..T-1), mixed with the spatial
    tokens by `time_mixer` before proj_out and the residual.

The embedding is time_embedding(sinusoid(c_noise, 320)) + label_emb(y),
y the frame's 1280-wide vector conditioning (sv3d.py builds it). conv_in
takes 8 channels: the input latent and the condition latent.

Under the profiler each temporal half with its mixer is the span
`teacher.temporal` (22 VideoResBlocks and 16 temporal transformers a call
at the published widths). Parameter names are the port's flax-style ones
for the spatial layers (`down_0_resnet_0`, `transformer_blocks_0`, ...)
and sgm's for the temporal ones (`time_stack`, `time_mixer.mix_factor`,
`time_pos_embed`). `set_quant` reaches the spatial layers' and the temporal
transformers' projections and feed-forwards; the (3, 1, 1) convolutions
stay exact (the int8 convolution takes square kernels only).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch.core.profiler import span
from contexture_nerf_tpu_torch.diffusion.layers import (
    Conv, CrossAttention, Dense, Downsample2D,
    FeedForward, LayerNormF32, ResnetBlock2D, TimestepEmbedding,
    Transformer2DModel, Upsample2D, timestep_embedding)
from contexture_nerf_tpu_torch.diffusion.unet import UNetConfig
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

HEAD_CHANNELS = 64  # sv3d_p.yaml num_head_channels


class VideoUNetConfig(UNetConfig):
    """sv3d_p.yaml's network_config: model_channels 320, channel_mult
    (1, 2, 4, 4), 2 res blocks, attention at the first three levels, heads
    of 64 channels, context_dim 1024, 8 input channels, adm_in_channels
    1280; `frames` the orbit's length (21)."""

    def __init__(self, in_channels=8, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2, cross_attention_dim=1024,
                 num_heads=None, transformer_depth=1, adm_in_channels=1280,
                 frames=21):
        heads = num_heads or tuple(c // HEAD_CHANNELS
                                   for c in block_out_channels)
        super().__init__(in_channels, out_channels, block_out_channels,
                         layers_per_block, cross_attention_dim, heads,
                         transformer_depth)
        self.adm_in_channels = adm_in_channels
        self.frames = frames

    @staticmethod
    def sv3d_p():
        return VideoUNetConfig()

    @staticmethod
    def tiny(frames: int = 5, cross_attention_dim: int = 32):
        return VideoUNetConfig(block_out_channels=(32, 64),
                               layers_per_block=1,
                               cross_attention_dim=cross_attention_dim,
                               num_heads=(2, 4), frames=frames)


class AlphaBlender(nn.Module):
    """merge_strategy "learned_with_images" on video (no image-only
    frames): a = sigmoid(mix_factor), out = a spatial + (1 - a) temporal."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def weights(self, dtype):
        """(a, 1 - a) in `dtype`, as sgm casts them."""
        a = torch.sigmoid(self.mix_factor.float())
        return a.to(dtype), (1.0 - a).to(dtype)


class TemporalConv(nn.Conv3d):
    """A (k, 1, 1) Conv3d over (B, C, T, h, w), run as the equal Conv2d
    over the (B, C, T, h w) view; casts its input to its own dtype."""

    def __init__(self, channels: int, k: int = 3):
        super().__init__(channels, channels, (k, 1, 1),
                         padding=(k // 2, 0, 0))

    def forward(self, x):
        return F.conv2d(x.to(self.weight.dtype), self.weight[..., 0],
                        self.bias, padding=(self.padding[0], 0))


class TemporalResBlock(nn.Module):
    """time_stack of a VideoResBlock (sgm ResBlock, dims 3, kernel (3,1,1),
    exchange_temb_dims): over x (B, C, T, S) and the frames' embeddings
    (B, T, E) returns the residual branch conv2(GN(conv1(GN(x)) + emb))."""

    def __init__(self, channels: int, temb_dim: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNormSiLU(channels, 32, 1e-5, out_dtype=dtype)
        self.conv1 = TemporalConv(channels)
        self.time_emb_proj = Dense(temb_dim, channels)
        self.norm2 = GroupNormSiLU(channels, 32, 1e-5, out_dtype=dtype)
        self.conv2 = TemporalConv(channels)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        e = self.time_emb_proj(F.silu(temb))  # (B, T, C)
        h = h + e.transpose(1, 2)[..., None]
        return self.conv2(self.norm2(h))


class VideoResBlock(ResnetBlock2D):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, temb_dim=temb_dim,
                         dtype=dtype)
        self.time_stack = TemporalResBlock(out_channels, temb_dim, dtype)
        self.time_mixer = AlphaBlender()

    def forward(self, x, temb, frames: int):
        s = super().forward(x, temb)
        with span("teacher.temporal"):
            BT, C, h, w = s.shape
            B = BT // frames
            # (B T, C, h, w) -> (B, C, T, h w): the layout whose groups
            # K6 normalises over all frames
            u = s.reshape(B, frames, C, h * w).transpose(1, 2).contiguous()
            r = self.time_stack(u, temb.reshape(B, frames, -1))
            _, b = self.time_mixer.weights(s.dtype)
            # one pass, in s's (contiguous) layout
            out = torch.addcmul(s.reshape(B, frames, C, h * w),
                                r.transpose(1, 2), b)
            return out.reshape(BT, C, h, w)


class VideoTransformerBlock(nn.Module):
    """sgm VideoTransformerBlock with ff_in (extra_ff_mix_layer) over the
    frames: x (B T, S, c) -> the block's output as a (B, T, S, c) view of
    (B, S, T, c) memory."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        head_dim = dim // num_heads
        self.norm_in = LayerNormF32(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, dtype)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                    dtype)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context_first, frames: int):
        """context_first (B, L, ctx): each batch item's first frame's
        context, attended from every position."""
        BT, S, C = x.shape
        B = BT // frames
        a = x.reshape(B, frames, S, C).transpose(1, 2).reshape(B * S, frames,
                                                               C)
        a = a + self.ff_in(self.norm_in(a).to(self.dtype))
        a = a + self.attn1(self.norm1(a).to(self.dtype))
        ctx = context_first.repeat_interleave(S, dim=0)
        a = a + self.attn2(self.norm2(a).to(self.dtype), context=ctx)
        a = a + self.ff(self.norm3(a).to(self.dtype))
        return a.reshape(B, S, frames, C).transpose(1, 2)


class SpatialVideoTransformer(Transformer2DModel):
    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 depth: int = 1, dtype=torch.float32):
        super().__init__(channels, num_heads, channels // num_heads,
                         context_dim, depth, dtype)
        for i in range(depth):
            setattr(self, f"time_stack_{i}", VideoTransformerBlock(
                channels, num_heads, context_dim, dtype))
        # the frame index's MLP, c -> 4c -> c
        self.time_pos_embed = TimestepEmbedding(channels, 4 * channels)
        self.time_pos_embed.linear_2 = Dense(4 * channels, channels)
        self.time_mixer = AlphaBlender()

    def forward(self, x, context, frames: int):
        BT, C, H, W = x.shape
        residual = x
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(BT, H * W,
                                                                  C))
        ctx_first = context[::frames]
        for i in range(self.depth):
            h = getattr(self, f"transformer_blocks_{i}")(h, context=context)
            with span("teacher.temporal"):
                idx = torch.arange(frames, device=x.device)
                pos = self.time_pos_embed(
                    timestep_embedding(idx, C).to(h.dtype))
                pos = pos.repeat(BT // frames, 1)[:, None, :]
                a = getattr(self, f"time_stack_{i}")(h + pos, ctx_first,
                                                     frames)
                _, b = self.time_mixer.weights(h.dtype)
                # a h + (1 - a) temporal, in h's (contiguous) layout
                h = torch.lerp(h.reshape(a.shape), a, b).reshape(BT, H * W, C)
        h = self.proj_out(h).reshape(BT, H, W, C).permute(0, 3, 1, 2)
        return residual + h


class VideoUNet(nn.Module):
    """forward(sample (B T, 8, h, w), c_noise (1,) or (B T,), context
    (B T, L, ctx), y (B T, adm)) -> (B T, 4, h, w) in the tower dtype."""

    def __init__(self, config: VideoUNetConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        c0 = cfg.block_out_channels[0]
        temb = 4 * c0
        nb = len(cfg.block_out_channels)
        self.time_embedding = TimestepEmbedding(c0, temb)
        self.label_emb = TimestepEmbedding(cfg.adm_in_channels, temb)
        self.conv_in = Conv(cfg.in_channels, c0, 3, padding=1)

        def transformer(bi, ch):
            return SpatialVideoTransformer(ch, cfg.num_heads[bi],
                                           cfg.cross_attention_dim,
                                           cfg.transformer_depth, dtype)

        ch, res_ch = c0, [c0]
        for bi, out_ch in enumerate(cfg.block_out_channels):
            for li in range(cfg.layers_per_block):
                setattr(self, f"down_{bi}_resnet_{li}",
                        VideoResBlock(ch, out_ch, temb, dtype))
                ch = out_ch
                if cfg.is_cross(bi):
                    setattr(self, f"down_{bi}_attn_{li}",
                            transformer(bi, out_ch))
                res_ch.append(out_ch)
            if bi < nb - 1:
                setattr(self, f"down_{bi}_downsample", Downsample2D(out_ch))
                res_ch.append(out_ch)
        self.mid_resnet_0 = VideoResBlock(ch, ch, temb, dtype)
        self.mid_attn = transformer(nb - 1, ch)
        self.mid_resnet_1 = VideoResBlock(ch, ch, temb, dtype)
        for bi in reversed(range(nb)):
            out_ch = cfg.block_out_channels[bi]
            for li in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{bi}_resnet_{li}", VideoResBlock(
                    ch + res_ch.pop(), out_ch, temb, dtype))
                ch = out_ch
                if cfg.is_cross(bi):
                    setattr(self, f"up_{bi}_attn_{li}",
                            transformer(bi, out_ch))
            if bi > 0:
                setattr(self, f"up_{bi}_upsample", Upsample2D(out_ch))
        self.conv_norm_out = GroupNormSiLU(c0, 32, 1e-5, out_dtype=dtype)
        self.conv_out = Conv(c0, cfg.out_channels, 3, padding=1)

    def mixers(self) -> List[AlphaBlender]:
        return [m for m in self.modules() if isinstance(m, AlphaBlender)]

    def forward(self, sample, c_noise, context, y):
        cfg, T = self.config, self.config.frames
        dtype = self.conv_in.weight.dtype
        x = sample.to(dtype)
        c0 = cfg.block_out_channels[0]
        t = torch.as_tensor(c_noise, device=x.device).reshape(-1)
        emb = self.time_embedding(timestep_embedding(t, c0).to(dtype)) + \
            self.label_emb(y.to(dtype))
        context = context.to(dtype)
        nb = len(cfg.block_out_channels)
        h = self.conv_in(x)
        hs = [h]
        for bi in range(nb):
            for li in range(cfg.layers_per_block):
                h = getattr(self, f"down_{bi}_resnet_{li}")(h, emb, T)
                if cfg.is_cross(bi):
                    h = getattr(self, f"down_{bi}_attn_{li}")(h, context, T)
                hs.append(h)
            if bi < nb - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                hs.append(h)
        h = self.mid_resnet_0(h, emb, T)
        h = self.mid_attn(h, context, T)
        h = self.mid_resnet_1(h, emb, T)
        for bi in reversed(range(nb)):
            for li in range(cfg.layers_per_block + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = getattr(self, f"up_{bi}_resnet_{li}")(h, emb, T)
                if cfg.is_cross(bi):
                    h = getattr(self, f"up_{bi}_attn_{li}")(h, context, T)
            if bi > 0:
                h = getattr(self, f"up_{bi}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))


def temporal_layers(cfg: VideoUNetConfig):
    """(VideoResBlocks, temporal transformers) of one call: 22 and 16 at
    the published widths."""
    nb, lpb = len(cfg.block_out_channels), cfg.layers_per_block
    cross = sum(1 for bi in range(nb) if cfg.is_cross(bi))
    return (nb * (2 * lpb + 1) + 2,
            (cross * (2 * lpb + 1) + 1) * cfg.transformer_depth)
