"""The plain reference of FLUX.1 Depth [dev] as the SDS teacher, in f32.

FLUX.1's MMDiT as github.com/black-forest-labs/flux writes it
(`src/flux/model.py`, `src/flux/modules/layers.py`, `src/flux/math.py`,
`src/flux/util.py` configs["flux-dev-depth"], `src/flux/sampling.py`):
the image tokens (2x2 patches of the noisy latents, beside the depth
image's packed latents) and the T5 states embedded to the hidden size; a
vector of the timestep's, the guidance's and the pooled text's embeddings;
19 double-stream blocks (separate image and text weights, adaLN-Zero
modulation, QK-RMSNorm, one attention over [text; image] with 3-axis
rotary embeddings) and 38 single-stream blocks (one linear holding QKV
and the MLP's input, one output linear over [attention; GELU(MLP)]); the
image tokens through the last layer. FLUX.1's AE encoder is the SD
encoder of `towers.py` with 16 latent channels and no quant_conv, its
latents (z - shift) scale.

The SDS step around it is the loop's (reference/sds.py), over the table
of flow times t_i = time_shift(mu, (i + 1) / 1000), alpha_bar =
(1 - t)^2 / ((1 - t)^2 + t^2): FLUX is fed s x at time t, s =
sqrt((1 - t)^2 + t^2), and its velocity eps - x0 becomes the VP
v-prediction (1 - 2 t) x + s v.

Weights may be held in bf16 (the published size does not fit the card
twice in f32): every linear and norm scale is cast to f32 where it is
used, and every product and sum runs in f32 with TF32 off. Attention is a
plain softmax, a block of query rows at a time. Parameter names are the
measured program's (BFL's), so portbench/weights.py's dictionaries load
into both.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import towers as rt
from portbench.reference.sds import (GRAD_SCALE, colors, dreamtime_schedule,
                                     split_grid_to_6)

NUM_IDX = 1000
GUIDANCE = 10.0
SHIFT, SCALE = 0.1159, 0.3611  # FLUX.1's AE (util.py ae_params)
ROWS = 1024  # query rows a block of the plain attention


class Config:
    def __init__(self, in_channels=128, out_channels=64, vec_in_dim=768,
                 context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
                 num_heads=24, depth=19, depth_single_blocks=38,
                 axes_dim=(16, 56, 56), theta=10000):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.vec_in_dim = vec_in_dim
        self.context_in_dim = context_in_dim
        self.hidden_size = hidden_size
        self.mlp_dim = int(hidden_size * mlp_ratio)
        self.num_heads = num_heads
        self.depth = depth
        self.depth_single_blocks = depth_single_blocks
        self.axes_dim = tuple(axes_dim)
        self.theta = theta

    @staticmethod
    def tiny():
        return Config(vec_in_dim=16, context_in_dim=32, hidden_size=64,
                      num_heads=2, depth=2, depth_single_blocks=2,
                      axes_dim=(8, 12, 12))


def vae_config(tiny: bool) -> rt.VAEConfig:
    blocks = ((32, 64), 1) if tiny else ((128, 256, 512, 512), 2)
    return rt.VAEConfig(3, 16, *blocks, SCALE)


def ae_encoder(vcfg: rt.VAEConfig) -> rt.Encoder:
    """towers.py's encoder without its quant_conv."""
    enc = rt.Encoder(vcfg)
    enc.quant_conv = nn.Identity()
    return enc


# -- pieces --------------------------------------------------------------------------

class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(x.float(), self.weight.float(), b)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        rrms = torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-6)
        return x * rrms * self.scale.float()


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden)
        self.out_layer = Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.lin = Linear(dim, n * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, dim=-1)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.norm = QKNorm(dim // heads)
        self.proj = Linear(dim, dim)


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def timestep_embedding(t, dim: int, max_period: int = 10000,
                       time_factor: float = 1000.0):
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope(pos, dim: int, theta: int):
    """(B, L, dim/2, 2, 2) rotation matrices of positions pos (B, L)."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64,
                         device=pos.device) / dim
    omega = 1.0 / theta ** scale
    out = pos.double()[..., None] * omega
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out),
                       torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def embed_nd(ids, axes_dim, theta):
    """(B, 1, L, d/2, 2, 2): the axes' rotations side by side."""
    return torch.cat([rope(ids[..., i], d, theta)
                      for i, d in enumerate(axes_dim)], dim=-3)[:, None]


def apply_rope(x, freqs):
    """x (B, H, L, d) by the rotations freqs (B, 1, L, d/2, 2, 2)."""
    x_ = x.reshape(*x.shape[:-1], -1, 1, 2)
    out = freqs[..., 0] * x_[..., 0] + freqs[..., 1] * x_[..., 1]
    return out.reshape(*x.shape)


def attention(q, k, v, pe, use_rope=True):
    """softmax(q k^T / sqrt(d)) v over (B, H, L, d), RoPE on q and k first;
    returns (B, L, H d)."""
    if use_rope:
        q, k = apply_rope(q, pe), apply_rope(k, pe)
    scale = q.shape[-1] ** -0.5
    out = torch.cat([torch.softmax(q[:, :, i:i + ROWS] @ k.transpose(-1, -2)
                                   * scale, dim=-1) @ v
                     for i in range(0, q.shape[2], ROWS)], dim=2)
    B, H, L, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(B, L, H * d)


def heads(qkv, n_heads):
    """(B, L, 3 H d) -> q, k, v (B, H, L, d)."""
    B, L, _ = qkv.shape
    x = qkv.reshape(B, L, 3, n_heads, -1).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


# -- the MMDiT -------------------------------------------------------------------------

class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        h, H = cfg.hidden_size, cfg.num_heads
        self.heads = H
        self.img_mod = Modulation(h, 6)
        self.img_attn = SelfAttention(h, H)
        self.img_mlp = nn.Sequential(Linear(h, cfg.mlp_dim),
                                     nn.GELU(approximate="tanh"),
                                     Linear(cfg.mlp_dim, h))
        self.txt_mod = Modulation(h, 6)
        self.txt_attn = SelfAttention(h, H)
        self.txt_mlp = nn.Sequential(Linear(h, cfg.mlp_dim),
                                     nn.GELU(approximate="tanh"),
                                     Linear(cfg.mlp_dim, h))

    def _qkv(self, attn, x, mod):
        q, k, v = heads(attn.qkv((1 + mod[1]) * layer_norm(x) + mod[0]),
                        self.heads)
        return attn.norm.query_norm(q), attn.norm.key_norm(k), v

    def forward(self, img, txt, vec, pe, use_rope=True):
        im, tm = self.img_mod(vec), self.txt_mod(vec)
        iq, ik, iv = self._qkv(self.img_attn, img, im)
        tq, tk, tv = self._qkv(self.txt_attn, txt, tm)
        attn = attention(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                         torch.cat([tv, iv], 2), pe, use_rope)
        n = txt.shape[1]
        img = img + im[2] * self.img_attn.proj(attn[:, n:])
        img = img + im[5] * self.img_mlp((1 + im[4]) * layer_norm(img)
                                         + im[3])
        txt = txt + tm[2] * self.txt_attn.proj(attn[:, :n])
        txt = txt + tm[5] * self.txt_mlp((1 + tm[4]) * layer_norm(txt)
                                         + tm[3])
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        h = self.hidden = cfg.hidden_size
        self.heads, self.mlp_dim = cfg.num_heads, cfg.mlp_dim
        self.linear1 = Linear(h, 3 * h + cfg.mlp_dim)
        self.linear2 = Linear(h + cfg.mlp_dim, h)
        self.norm = QKNorm(h // cfg.num_heads)
        self.modulation = Modulation(h, 3)

    def forward(self, x, vec, pe, use_rope=True):
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = self.linear1((1 + scale) * layer_norm(x) + shift).split(
            [3 * self.hidden, self.mlp_dim], dim=-1)
        q, k, v = heads(qkv, self.heads)
        q, k = self.norm.query_norm(q), self.norm.key_norm(k)
        attn = attention(q, k, v, pe, use_rope)
        out = self.linear2(torch.cat(
            [attn, F.gelu(mlp, approximate="tanh")], dim=2))
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, h: int, out_channels: int):
        super().__init__()
        self.linear = Linear(h, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(h, 2 * h))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        x = (1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :]
        return self.linear(x)


class Flux(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.img_in = Linear(cfg.in_channels, h)
        self.time_in = MLPEmbedder(256, h)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, h)
        self.guidance_in = MLPEmbedder(256, h)
        self.txt_in = Linear(cfg.context_in_dim, h)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(cfg) for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(h, cfg.out_channels)

    def forward(self, img, img_ids, txt, txt_ids, timesteps, y, guidance,
                use_rope=True):
        img = self.img_in(img)
        vec = self.time_in(timestep_embedding(timesteps, 256))
        vec = vec + self.guidance_in(timestep_embedding(guidance, 256))
        vec = vec + self.vector_in(y)
        txt = self.txt_in(txt)
        pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), self.cfg.axes_dim,
                      self.cfg.theta)
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, pe, use_rope)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            x = block(x, vec, pe, use_rope)
        return self.final_layer(x[:, txt.shape[1]:], vec)


# -- packing and the flow table ------------------------------------------------------

def pack(z):
    """b c (h ph) (w pw) -> b (h w) (c ph pw)."""
    B, C, H, W = z.shape
    z = z.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return z.reshape(B, (H // 2) * (W // 2), 4 * C)


def unpack(x, h: int, w: int):
    B, _, D = x.shape
    x = x.reshape(B, h, w, D // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, D // 4, 2 * h, 2 * w)


def ids_of(h: int, w: int, text_tokens: int, device):
    """(img_ids (1, h w, 3) = (0, row, col), txt_ids (1, L, 3) = 0)."""
    img = torch.zeros(h, w, 3, device=device)
    img[..., 1] = torch.arange(h, device=device)[:, None]
    img[..., 2] = torch.arange(w, device=device)[None, :]
    return img.reshape(1, h * w, 3), torch.zeros(1, text_tokens, 3,
                                                  device=device)


def mu_at(image_tokens: int) -> float:
    m = (1.15 - 0.5) / (4096 - 256)
    return 0.5 + m * (image_tokens - 256)


def flow_times(image_tokens: int, device=None) -> torch.Tensor:
    """(1000,) f64 flow times t_i = time_shift(mu, (i + 1) / 1000)."""
    mu = mu_at(image_tokens)
    s = torch.arange(1, NUM_IDX + 1, dtype=torch.float64) / NUM_IDX
    return (math.exp(mu) / (math.exp(mu) + (1 / s - 1))).to(device)


def alphas_cumprod(image_tokens: int, device=None) -> torch.Tensor:
    t = flow_times(image_tokens)
    return ((1 - t) ** 2 / ((1 - t) ** 2 + t ** 2)).float().to(device)


def schedule(image_tokens: int, total_iterations: int):
    return dreamtime_schedule(alphas_cumprod(image_tokens), total_iterations)


# -- the SDS step ------------------------------------------------------------------------

class FluxSDSReference:
    """`towers` = (Flux, AE encoder) (weights in f32 or bf16, computed in
    f32); `mlp` a NeRF2D in f32; `inputs`: depth_grid (1, 3, 3t, 2t) in
    [0, 1], mask_grid, uv_pts, txt (1, L, ctx), vec (1, vec_in); `optim`
    (lr, betas, eps). `use_rope` False is the planted fault's teacher."""

    def __init__(self, towers, mlp, inputs: Dict, tile_px: int,
                 margin_px: int, optim: Tuple[float, Sequence[float], float],
                 guidance: float = GUIDANCE):
        self.flux, self.vae = towers
        self.mlp = mlp
        self.inp = inputs
        self.tile_px = tile_px
        self.vae_down = 2 ** (len(self.vae.config.block_out_channels) - 1)
        self.lat_tile = tile_px // self.vae_down
        self.grid_hw = (3 * tile_px, 2 * tile_px)
        self.sl_h = min(tile_px + 2 * margin_px, self.grid_hw[0])
        self.sl_w = min(tile_px + 2 * margin_px, self.grid_hw[1])
        self.guidance = guidance
        dev = inputs["depth_grid"].device
        H, W = self.grid_hw
        self.hw = (H // self.vae_down // 2, W // self.vae_down // 2)
        n = self.hw[0] * self.hw[1]
        t = flow_times(n)
        self.t = t.float().to(dev)
        self.s = ((1 - t) ** 2 + t ** 2).sqrt().float().to(dev)
        self.acp = alphas_cumprod(n, dev)
        self.img_ids, self.txt_ids = ids_of(*self.hw, inputs["txt"].shape[1],
                                            dev)
        with torch.no_grad():
            self.control = pack(self._latents(inputs["depth_grid"] * 2 - 1))
        lr, betas, eps = optim
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=lr,
                                          betas=tuple(betas), eps=eps)

    def _latents(self, img, eps=None):
        mean, logvar = rt.encode_moments(self.vae, img)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        return (z - SHIFT) * SCALE

    def _query(self, window=None):
        H, W = self.grid_hw
        uv = self.inp["uv_pts"]
        if window is not None:
            oy, ox, h, w = window
            uv = uv.reshape(H, W, 2)[oy:oy + h, ox:ox + w].reshape(-1, 2)
        return colors(self.mlp, uv)

    @staticmethod
    def _composite(rgb, h, w, mask):
        img = rgb.reshape(h, w, 3).permute(2, 0, 1)[None]
        return torch.clamp(img * mask + 0.5 * (1 - mask), 0.0, 1.0) * 2 - 1

    def slice_origin(self, tile_idx: int):
        tp, vd = self.tile_px, self.vae_down
        H, W = self.grid_hw
        row, col = tile_idx % 3, tile_idx // 3
        oy = min(max(row * tp - (self.sl_h - tp) // 2, 0), H - self.sl_h)
        ox = min(max(col * tp - (self.sl_w - tp) // 2, 0), W - self.sl_w)
        return (oy // vd) * vd, (ox // vd) * vd

    def render_latent(self, eps, tile_idx: int):
        """The canvas forward only, the gradient through the slice around
        the sampled tile (local_sds_grad), grafted as a zero-valued delta."""
        with torch.no_grad():
            z_full = self._latents(self._composite(
                self._query(), *self.grid_hw, self.inp["mask_grid"]), eps)
        tp, vd, lt = self.tile_px, self.vae_down, self.lat_tile
        sl_h, sl_w = self.sl_h, self.sl_w
        row, col = tile_idx % 3, tile_idx // 3
        oy, ox = self.slice_origin(tile_idx)
        patch = self._composite(
            self._query((oy, ox, sl_h, sl_w)), sl_h, sl_w,
            self.inp["mask_grid"][:, :, oy:oy + sl_h, ox:ox + sl_w])
        z_l = self._latents(patch, eps[:, :, oy // vd:(oy + sl_h) // vd,
                                       ox // vd:(ox + sl_w) // vd])
        ty, tx = (row * tp - oy) // vd, (col * tp - ox) // vd
        z_l_tile = z_l[:, :, ty:ty + lt, tx:tx + lt]
        zy, zx = row * lt, col * lt
        z = z_full.clone()
        z[:, :, zy:zy + lt, zx:zx + lt] = \
            z_full[:, :, zy:zy + lt, zx:zx + lt] + (z_l_tile - z_l_tile.detach())
        return z

    def v_pred(self, x, t: int, use_rope=True):
        """The VP v-prediction at the VP-noised latent x: FLUX at flow time
        t_i on s_i x beside the control latents, (1 - 2 t_i) x + s_i v."""
        t_i, s_i = self.t[t], self.s[t]
        img = torch.cat([pack(s_i * x), self.control], dim=-1)
        v = self.flux(img, self.img_ids, self.inp["txt"], self.txt_ids,
                      t_i.reshape(1), self.inp["vec"],
                      torch.full((1,), self.guidance, device=x.device),
                      use_rope)
        return (1 - 2 * t_i) * x + s_i * unpack(v, *self.hw)

    def step(self, t: int, d: Dict) -> Dict:
        """One step on the draws d (tile_idx, eps, noise); returns the loss,
        each leaf's gradient, the whole canvas's Fisher divergence and the
        v-prediction."""
        tile_idx = int(d["tile_idx"])
        eps, noise = d["eps"].float(), d["noise"].float()
        self.optimizer.zero_grad(set_to_none=True)
        z = self.render_latent(eps, tile_idx)
        z_sg = z.detach()
        a = self.acp[int(t)]
        with torch.no_grad():
            noisy = torch.sqrt(a) * z_sg + torch.sqrt(1 - a) * noise
            v_pred = self.v_pred(noisy, int(t))
        v = torch.sqrt(a) * noise - torch.sqrt(1 - a) * z_sg
        g = torch.nan_to_num(GRAD_SCALE * (1 - a) * torch.sqrt(a)
                             * (v_pred - v))
        targets = (z_sg - g).detach()
        zt = split_grid_to_6(z, self.lat_tile)[tile_idx]
        tt6 = split_grid_to_6(targets, self.lat_tile)[tile_idx]
        loss = 0.5 * torch.sum((zt - tt6) ** 2)
        loss.backward()
        grads = {k: p.grad.detach().clone()
                 for k, p in self.mlp.named_parameters()}
        self.optimizer.step()
        fisher = torch.sum((torch.sqrt(a) / torch.clamp(torch.sqrt(1 - a),
                                                        min=1e-8)) ** 2
                           * (v_pred - v) ** 2)
        return {"loss": float(loss.detach()), "grads": grads,
                "fisher": float(fisher), "v_pred": v_pred, "noisy": noisy}
