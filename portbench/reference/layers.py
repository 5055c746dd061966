"""Plain Stable-Diffusion building blocks (NCHW) of the frozen reference.

A frozen copy of the plain arithmetic of the measured program's tower
layers, with every kernel route taken out: GroupNorm is computed in f32 by
torch operations, attention is matmul + softmax with f32 logits, and no
layer quantizes or shards. Submodule and parameter names are the program's,
so one weight dictionary made by `portbench/weights.py` loads into both.
The reference runs in f32 with TF32 off (`reference/__init__.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class GroupNormSiLU(nn.Module):
    """GroupNorm (f32 statistics) -> optional SiLU -> cast."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 act: bool = True, out_dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.act, self.out_dtype = \
            groups, eps, act, out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight.float(),
                         self.bias.float(), self.eps)
        if self.act:
            y = F.silu(y)
        return y.to(self.out_dtype)


class LayerNormF32(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), 1e-5)


def attention(q, k, v, extra_k=None, extra_v=None):
    """(B, H, S, d) multi-head attention; the extra KV source (Zero123++
    reference attention) is attended jointly with k/v."""
    if extra_k is not None:
        k = torch.cat([k, extra_k], dim=2)
        v = torch.cat([v, extra_v], dim=2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, flip_sin_to_cos, max period 10000, [cos, sin]."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return F.pad(out, (0, dim % 2))


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5,
                 temb_dim: int = None, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, 32, eps, out_dtype=dtype)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (Dense(temb_dim, out_channels)
                              if temb_dim is not None else None)
        self.norm2 = GroupNormSiLU(out_channels, 32, eps, out_dtype=dtype)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 conv; the VAE encoder's (asymmetric) pads right and bottom."""

    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv(channels, channels, 3, stride=2,
                         padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)

    def _split(self, t):
        B, S, _ = t.shape
        return t.reshape(B, S, self.num_heads, self.head_dim).permute(
            0, 2, 1, 3)

    def forward(self, x, context=None, ref_kv=None):
        ctx = x if context is None else context
        q = self._split(self.to_q(x))
        k = self._split(self.to_k(ctx))
        v = self._split(self.to_v(ctx))
        ek = ev = None
        if ref_kv is not None:
            r = ref_kv.to(self.dtype)
            ek = self._split(self.to_k(r))
            ev = self._split(self.to_v(r))
        out = attention(q, k, v, ek, ev)
        B, _, Sq, _ = out.shape
        return self.to_out(out.permute(0, 2, 1, 3).reshape(B, Sq, -1))


class FeedForward(nn.Module):
    """GEGLU feed-forward with the exact (erf) GELU of the published
    model."""

    def __init__(self, dim: int):
        super().__init__()
        inner = dim * 4
        self.geglu_proj = Dense(dim, inner * 2)
        self.out_proj = Dense(inner, dim)

    def forward(self, x):
        h, gate = self.geglu_proj(x).chunk(2, dim=-1)
        return self.out_proj(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, dtype)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                    dtype)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, ref_kv=None, ref_out=None):
        """ref_out collects attn1's input tokens (write pass); ref_kv is
        appended to attn1's keys and values (read pass)."""
        h = self.norm1(x)
        if ref_out is not None:
            ref_out.append(h)
        x = x + self.attn1(h.to(self.dtype), ref_kv=ref_kv)
        h = self.norm2(x)
        x = x + self.attn2(h.to(self.dtype), context=context)
        h = self.norm3(x)
        return x + self.ff(h.to(self.dtype))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, depth: int = 1, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self.norm = GroupNormSiLU(channels, 32, 1e-6, act=False,
                                  out_dtype=dtype)
        self.proj_in = Dense(channels, channels)
        self.proj_out = Dense(channels, channels)
        for i in range(depth):
            setattr(self, f"transformer_blocks_{i}", BasicTransformerBlock(
                channels, num_heads, head_dim, context_dim, dtype))

    def forward(self, x, context=None, ref_kv_list=None, ref_out=None):
        B, C, H, W = x.shape
        residual = x
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for i in range(self.depth):
            rkv = ref_kv_list.pop(0) if ref_kv_list is not None else None
            h = getattr(self, f"transformer_blocks_{i}")(
                h, context=context, ref_kv=rkv, ref_out=ref_out)
        h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return residual + h
