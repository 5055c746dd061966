"""FLUX.1 Depth [dev] as the SDS teacher (guide.teacher "flux_depth";
https://huggingface.co/black-forest-labs/FLUX.1-Depth-dev): Black Forest
Labs' rectified-flow multimodal diffusion transformer with the depth image's
latents concatenated to the noisy latents along channels, and FLUX.1's AE
encoder (vae.py `VAEConfig.flux`). The equations are those of
github.com/black-forest-labs/flux: `src/flux/model.py` (Flux),
`src/flux/modules/layers.py` (EmbedND, rope, MLPEmbedder, RMSNorm,
QKNorm, Modulation, DoubleStreamBlock, SingleStreamBlock, LastLayer,
timestep_embedding), `src/flux/math.py` (attention, apply_rope),
`src/flux/util.py` (configs["flux-dev-depth"]: in_channels 128,
out_channels 64, vec_in_dim 768, context_in_dim 4096, hidden_size 3072,
mlp_ratio 4, num_heads 24, depth 19, depth_single_blocks 38, axes_dim
(16, 56, 56), theta 10000, with qkv_bias and guidance_embed) and
`src/flux/sampling.py` (get_lin_function, time_shift, pack, unpack).
Submodules keep BFL's names (`double_blocks.0.img_attn.qkv`, ...).

The SDS loop's table (`FluxDepthTeacher.make_tables`), as read for this
port: flow times t_i = time_shift(mu, (i + 1) / 1000) for i < 1000, with
time_shift(mu, s) = e^mu / (e^mu + 1/s - 1) and mu FLUX's linear rule
from (256 image tokens, 0.5) to (4096, 1.15) at the call's image tokens
(0.8629 at the 960x640 canvas's 2,400); alpha_bar_i = (1 - t_i)^2 /
((1 - t_i)^2 + t_i^2). With s_i = sqrt((1 - t_i)^2 + t_i^2), the VP latent
x = sqrt(alpha_bar) x0 + sqrt(1 - alpha_bar) eps is the flow latent
x_t = (1 - t) x0 + t eps over s_i: the teacher feeds FLUX s_i x at time t_i
and returns v_vp = (1 - 2 t_i) x + s_i v_flow, which is sqrt(alpha_bar) eps
- sqrt(1 - alpha_bar) x0 for FLUX's v_flow = eps - x0. The port's add_noise,
velocity_target, DreamTime, loss and Fisher check then apply as they are.

Where this port departs from, or adds to, the equations and settings
above:

  - The control latents are encoded from the depth grid when the trainer
    is built (`FluxSDSTrainer`, hoisted as the Zero123++ ControlNet's hint
    embedding is), not in `prepare`; `prepare` hands over the grid itself,
    so a caller that supplies its own grid (the benchmark) gets the same
    encode. They are the AE's mode (diffusers' FluxControlPipeline
    samples the posterior).
  - The grid's depth tiles are composited on grey (0.5), as the Zero123++
    grid's are: mapped to [-1, 1] the background reads 0.
  - The prompt's T5 states and CLIP-L pooled vector have no towers here:
    `prompt_states` draws them N(0, 1) from the generator, 512 x 4096 and
    768 wide (8 x 32 and 16 at tiny size).
  - The modulated LayerNorms ((1 + scale) LN(x) + shift) are computed in
    f32 and rounded once to the tower's dtype, and q and k are rotated in
    the (B, L, H, d) layout the projections write, so the kernel reads them
    through strides; BFL rounds each step of the modulation in bf16. The
    residual stream stays in the tower's dtype, as BFL's does.
  - The guidance of 10.0 follows the diffusers FluxControlPipeline example
    for this checkpoint (BFL's own demo uses 10 too); it enters through
    `guidance_in` and there is one forward a step, no unconditional pass.
  - The `trainer` canvas composite is not Zero123++'s `scale_image`: the
    AE takes the image in [-1, 1].

Without a checkpoint the towers get seeded random weights
(`random_init_`); at full size they are made on the card in the tower's
dtype (an init of 11.9 B parameters in f32 on the host would take minutes
and 48 GB). The published `flux1-depth-dev.safetensors`, `ae.safetensors`
and the T5-XXL / CLIP-L text towers have no loader yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.core import profiler
from contexture_nerf_tpu_torch.diffusion import layers
from contexture_nerf_tpu_torch.diffusion.layers import (Dense, set_quant,
                                                        timestep_embedding)
from contexture_nerf_tpu_torch.diffusion.vae import (Encoder, VAEConfig,
                                                     encode_moments)
from contexture_nerf_tpu_torch.diffusion.zero123plus import random_init_

NUM_IDX = 1000
GUIDANCE = 10.0
TEXT_TOKENS = 512
TILE_PX = 320
EPS = 1e-6  # the LayerNorms' and the QK RMSNorms'


class FluxConfig:
    """The MMDiT's sizes (flux `util.py` FluxParams)."""

    def __init__(self, in_channels=128, out_channels=64, vec_in_dim=768,
                 context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
                 num_heads=24, depth=19, depth_single_blocks=38,
                 axes_dim=(16, 56, 56), theta=10000):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.vec_in_dim = vec_in_dim
        self.context_in_dim = context_in_dim
        self.hidden_size = hidden_size
        self.mlp_ratio = mlp_ratio
        self.num_heads = num_heads
        self.depth = depth
        self.depth_single_blocks = depth_single_blocks
        self.axes_dim = tuple(axes_dim)
        self.theta = theta
        if hidden_size % num_heads or sum(axes_dim) != self.head_dim:
            raise ValueError("hidden_size / num_heads must equal the RoPE "
                             f"axes' sum: {hidden_size} / {num_heads}, "
                             f"{axes_dim}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def flux_depth_dev():
        return FluxConfig()

    @staticmethod
    def tiny():
        return FluxConfig(vec_in_dim=16, context_in_dim=32, hidden_size=64,
                          num_heads=2, depth=2, depth_single_blocks=2,
                          axes_dim=(8, 12, 12))


# -- rotary embeddings, packing, the flow table -------------------------------

def rope_tables(ids: torch.Tensor, axes_dim, theta: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (B, L, 1, d/2) f32 of positions `ids` (B, L, n_axes):
    axis a of width d_a turns the pairs (x_2i, x_2i+1) of its d_a columns
    by ids[..., a] theta^(-2i/d_a); the axes' columns follow one another
    (EmbedND), the angles taken in f64 as `rope` does."""
    angles = []
    for a, d in enumerate(axes_dim):
        scale = torch.arange(0, d, 2, dtype=torch.float64,
                             device=ids.device) / d
        omega = 1.0 / theta ** scale
        angles.append(ids[..., a].double()[..., None] * omega)
    ang = torch.cat(angles, dim=-1)[:, :, None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def image_ids(h: int, w: int, device) -> torch.Tensor:
    """(1, h w, 3): (0, row, col) of the packed image tokens."""
    rows = torch.arange(h, device=device).repeat_interleave(w)
    cols = torch.arange(w, device=device).repeat(h)
    return torch.stack([torch.zeros_like(rows), rows, cols], -1)[None].float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, L, H, d) turned pair by pair in f32, cast back (apply_rope)."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], -1)
    return out.flatten(-2).to(x.dtype)


def pack(z: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 W/2, 4 C): 2x2 patches, (c ph pw) order."""
    B, C, H, W = z.shape
    z = z.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return z.reshape(B, (H // 2) * (W // 2), C * 4)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """pack's inverse: (B, h w, 4 C) -> (B, C, 2h, 2w)."""
    B, _, D = x.shape
    x = x.reshape(B, h, w, D // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, D // 4, 2 * h, 2 * w)


def time_shift(mu: float, s: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))


def flow_mu(image_tokens: int, x1: int = 256, y1: float = 0.5,
            x2: int = 4096, y2: float = 1.15) -> float:
    """FLUX's schedule shift at `image_tokens` (get_lin_function)."""
    m = (y2 - y1) / (x2 - x1)
    return m * image_tokens + (y1 - m * x1)


def flow_table(mu: float, n: int = NUM_IDX, device=None
               ) -> Dict[str, torch.Tensor]:
    """The SDS loop's table over n indices (module docstring): flow times
    `t`, the VP scale `s` = sqrt((1 - t)^2 + t^2) and `alphas_cumprod`,
    f32, taken in f64."""
    t = time_shift(mu, torch.arange(1, n + 1, dtype=torch.float64) / n)
    s2 = (1 - t) ** 2 + t ** 2
    return {"t": t.float().to(device), "s": s2.sqrt().float().to(device),
            "alphas_cumprod": ((1 - t) ** 2 / s2).float().to(device)}


def flow_to_vp(x: torch.Tensor, v_flow: torch.Tensor, t, s) -> torch.Tensor:
    """The VP v-prediction at the VP latent x from FLUX's velocity v_flow at
    flow time t on s x (module docstring): (1 - 2 t) x + s v_flow."""
    return (1 - 2 * t) * x + s * v_flow


# -- the MMDiT ------------------------------------------------------------------------

def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=EPS)


def modulate(x, shift, scale) -> torch.Tensor:
    """(1 + scale) LN(x) + shift in f32, cast to x's dtype."""
    return ((1 + scale.float()) * layer_norm(x) + shift.float()).to(x.dtype)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = Dense(in_dim, hidden)
        self.out_layer = Dense(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    """Over the last axis in f32, eps 1e-6; the product cast back before the
    learned scale multiplies it."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        rrms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
        return (xf * rrms).to(x.dtype) * self.scale


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class Modulation(nn.Module):
    """Linear(SiLU(vec)) cut into 3 (single) or 6 (double) of (shift, scale,
    gate), each (B, 1, h)."""

    QUANT = ("lin",)

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = Dense(dim, self.multiplier * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, -1)


class SelfAttention(nn.Module):
    """A stream's qkv and output projections and its QK-RMSNorm (the
    attention is the block's, over both streams)."""

    QUANT = ("qkv", "proj")

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.norm = QKNorm(dim // num_heads)
        self.proj = Dense(dim, dim)

    def qkv_heads(self, x):
        """(q, k, v) (B, L, H, d): q and k RMS-normed, v a view."""
        qkv = self.qkv(x).unflatten(-1, (3, self.num_heads, -1))
        return (self.norm.query_norm(qkv[:, :, 0]),
                self.norm.key_norm(qkv[:, :, 1]), qkv[:, :, 2])


class GELUMLP(nn.Sequential):
    """Linear -> tanh GELU -> Linear (the streams' `*_mlp`)."""

    QUANT = ("0", "2")

    def __init__(self, dim: int, hidden: int):
        super().__init__(Dense(dim, hidden), nn.GELU(approximate="tanh"),
                         Dense(hidden, dim))


def joint_attention(q, k, v, cos, sin):
    """RoPE on q and k, then attention over the heads of (B, L, H, d)
    tensors through `layers.attention` (the flash kernel at these lengths on
    the card). Returns (B, L, H d), the kernel's (B, L, H, d) output
    memory."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = layers.attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                           v.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).flatten(2)


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h, heads = cfg.hidden_size, cfg.num_heads
        self.img_mod = Modulation(h, double=True)
        self.img_attn = SelfAttention(h, heads)
        self.img_mlp = GELUMLP(h, cfg.mlp_dim)
        self.txt_mod = Modulation(h, double=True)
        self.txt_attn = SelfAttention(h, heads)
        self.txt_mlp = GELUMLP(h, cfg.mlp_dim)

    def forward(self, img, txt, vec, cos, sin):
        im = self.img_mod(vec)  # shift, scale, gate of attention, of MLP
        tm = self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_heads(modulate(img, im[0], im[1]))
        tq, tk, tv = self.txt_attn.qkv_heads(modulate(txt, tm[0], tm[1]))
        attn = joint_attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                               torch.cat([tv, iv], 1), cos, sin)
        n = txt.shape[1]
        img = img + im[2] * self.img_attn.proj(attn[:, n:])
        img = img + im[5] * self.img_mlp(modulate(img, im[3], im[4]))
        txt = txt + tm[2] * self.txt_attn.proj(attn[:, :n])
        txt = txt + tm[5] * self.txt_mlp(modulate(txt, tm[3], tm[4]))
        return img, txt


class SingleStreamBlock(nn.Module):
    QUANT = ("linear1", "linear2")

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h = self.hidden_size = cfg.hidden_size
        self.num_heads, self.mlp_dim = cfg.num_heads, cfg.mlp_dim
        self.linear1 = Dense(h, 3 * h + cfg.mlp_dim)
        self.linear2 = Dense(h + cfg.mlp_dim, h)
        self.norm = QKNorm(cfg.head_dim)
        self.modulation = Modulation(h, double=False)

    def forward(self, x, vec, cos, sin):
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = self.linear1(modulate(x, shift, scale)).split(
            [3 * self.hidden_size, self.mlp_dim], -1)
        qkv = qkv.unflatten(-1, (3, self.num_heads, -1))
        q = self.norm.query_norm(qkv[:, :, 0])
        k = self.norm.key_norm(qkv[:, :, 1])
        attn = joint_attention(q, k, qkv[:, :, 2], cos, sin)
        out = self.linear2(torch.cat([attn, F.gelu(mlp, approximate="tanh")],
                                     -1))
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, h: int, out_channels: int):
        super().__init__()
        self.linear = Dense(h, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(h, 2 * h))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec)[:, None, :].chunk(2, -1)
        return self.linear(modulate(x, shift, scale))


class FluxTransformer(nn.Module):
    """FLUX's MMDiT (flux `model.py` Flux). `forward` takes the packed image
    tokens (B, N, in_channels) with their (h, w) grid, the text states
    (B, L, context_in_dim), flow times (B,), guidance (B,) and the pooled
    vector (B, vec_in_dim); text tokens sit at position (0, 0, 0). Each
    double-stream block runs in the span `flux.double`, each single-stream
    block in `flux.single`."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.img_in = Dense(cfg.in_channels, h)
        self.time_in = MLPEmbedder(256, h)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, h)
        self.guidance_in = MLPEmbedder(256, h)
        self.txt_in = Dense(cfg.context_in_dim, h)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(cfg) for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(h, cfg.out_channels)

    def rope(self, hw: Tuple[int, int], text_tokens: int, device):
        """(cos, sin) of the joint sequence: text (zeros), then image."""
        ids = torch.cat([torch.zeros((1, text_tokens, 3), device=device),
                         image_ids(*hw, device)], 1)
        return rope_tables(ids, self.config.axes_dim, self.config.theta)

    def forward(self, img, hw, txt, timesteps, guidance, y, pe=None):
        cos, sin = pe if pe is not None else self.rope(hw, txt.shape[1],
                                                       img.device)
        vec = self.time_in(timestep_embedding(1000.0 * timesteps, 256))
        vec = vec + self.guidance_in(timestep_embedding(1000.0 * guidance,
                                                        256))
        vec = vec + self.vector_in(y)
        img, txt = self.img_in(img), self.txt_in(txt)
        for block in self.double_blocks:
            with profiler.span("flux.double"):
                img, txt = block(img, txt, vec, cos, sin)
        x = torch.cat([txt, img], 1)
        for block in self.single_blocks:
            with profiler.span("flux.single"):
                x = block(x, vec, cos, sin)
        return self.final_layer(x[:, txt.shape[1]:], vec)


# -- the teacher ---------------------------------------------------------------------

class FluxDepthTeacher(nn.Module):
    """The FLUX.1 Depth [dev] towers in one dtype (bf16 at full size, f32 at
    tiny size): `transformer` (FluxTransformer) and `vae_encoder` (FLUX.1's
    AE encoder). The SDS loop's 3x2 grid of `tile_px`^2 tiles (320^2: a
    960x640 canvas, 2,400 packed image tokens; tiny 32^2) and its flow
    table (module docstring) at that canvas's tokens. `set_int8` turns
    W8A8 on in the blocks' linears (optim.int8_teacher). The towers are
    made from `generator` (without one their storage is left for a load to
    fill); `weight_paths` must be None (no loader for the published weights
    yet). `counts` keeps the teacher's calls and the
    image and text tokens of the last one."""

    BOOTSTRAPS = False  # no condition image: prepare needs no SD2 repaint

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weight_paths=None):
        super().__init__()
        if weight_paths is not None:
            raise ValueError("guide.teacher 'flux_depth' makes its towers "
                             "from the seed: guide.zero123plus_path / "
                             "controlnet_path name Zero123++ weights")
        dev = resolve_device(device)
        self.dtype = torch.float32 if tiny else torch.bfloat16
        self.config = FluxConfig.tiny() if tiny else \
            FluxConfig.flux_depth_dev()
        self.vae_config = VAEConfig.flux(tiny=tiny)
        self.tile_px = 32 if tiny else TILE_PX
        self.text_tokens = 8 if tiny else TEXT_TOKENS
        self.guidance = GUIDANCE
        lat = self.tile_px // self.vae_config.downsample
        self.packed_hw = (3 * lat // 2, 2 * lat // 2)
        self.image_tokens = self.packed_hw[0] * self.packed_hw[1]
        self.mu = flow_mu(self.image_tokens)
        # made on the meta device, then given storage in the tower's dtype
        # where it runs: no f32 copy of the 11.9 B parameters is ever made
        with torch.device("meta"):
            self.transformer = FluxTransformer(self.config)
            self.vae_encoder = Encoder(self.vae_config, self.dtype)
        self.to(self.dtype)
        if dev.type != "meta":
            self.to_empty(device=dev)
            if generator is not None:
                with torch.no_grad():
                    random_init_(self, generator)
        self.requires_grad_(False)
        self.counts = {"calls": 0, "image_tokens": 0, "text_tokens": 0}
        self._rope = {}
        self.make_tables(dev)
        self.set_int8()

    def make_tables(self, device) -> None:
        """The flow table on `device` (a teacher built on the meta device
        makes it again where its weights go)."""
        table = flow_table(self.mu, device=device)
        self.flow_t, self.flow_s = table["t"], table["s"]
        self.alphas_cumprod = table["alphas_cumprod"]
        self._rope = {}

    def set_int8(self, int8_controlnet: bool = False,
                 int8_unet: bool = False) -> None:
        """W8A8 block linears with int8_unet (there is no ControlNet)."""
        self.int8_unet = bool(int8_unet)
        set_quant(self.transformer, self.int8_unet)

    def latents(self, image: torch.Tensor, eps: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """images (B, 3, H, W) in [-1, 1] -> (z - shift) scale, z the AE's
        posterior sample with the normal draw `eps`, or its mode."""
        mean, logvar = encode_moments(self.vae_encoder, image)
        z = mean if eps is None else \
            mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        c = self.vae_config
        return (z - c.shift_factor) * c.scaling_factor

    @torch.no_grad()
    def control_latents(self, depth_grid: torch.Tensor) -> torch.Tensor:
        """The depth grid (1, 3, H, W) in [0, 1] -> its packed control
        latents (1, N, 64): the AE's mode of 2 d - 1, shifted and scaled."""
        return pack(self.latents(depth_grid * 2 - 1)).to(self.dtype)

    def prompt_states(self, generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prompt's T5 states (1, text_tokens, context_in_dim) and CLIP-L
        pooled vector (1, vec_in_dim), drawn N(0, 1) (no text towers yet)."""
        dev = generator.device
        txt = torch.randn((1, self.text_tokens, self.config.context_in_dim),
                          generator=generator, device=dev)
        vec = torch.randn((1, self.config.vec_in_dim), generator=generator,
                          device=dev)
        return txt.to(self.dtype), vec.to(self.dtype)

    def rope(self, hw, text_tokens: int, device):
        key = (tuple(hw), text_tokens, str(device))
        if key not in self._rope:
            self._rope[key] = self.transformer.rope(hw, text_tokens, device)
        return self._rope[key]

    @torch.no_grad()
    def teacher_v_pred(self, latents_noisy: torch.Tensor, t: torch.Tensor,
                       control: torch.Tensor, txt: torch.Tensor,
                       vec: torch.Tensor, guidance: float = GUIDANCE
                       ) -> torch.Tensor:
        """The VP v-prediction at the VP-noised latent (1, 16, H, W) at
        index t of the table: one FLUX call at flow time t_i on s_i x (its
        packed tokens beside the packed control latents), guidance through
        guidance_in, converted by v_vp = (1 - 2 t_i) x + s_i v_flow."""
        x = latents_noisy.float()
        t = torch.as_tensor(t, device=x.device).reshape(-1)
        tf = self.flow_t[t]
        s = self.flow_s[t].reshape(-1, 1, 1, 1)
        B, _, H, W = x.shape
        hw = (H // 2, W // 2)
        img = torch.cat([pack(s * x).to(self.dtype),
                         control.to(self.dtype).expand(B, -1, -1)], -1)
        g = torch.full((B,), float(guidance), device=x.device)
        v_flow = self.transformer(
            img, hw, txt.to(self.dtype).expand(B, -1, -1), tf, g,
            vec.to(self.dtype).expand(B, -1),
            pe=self.rope(hw, txt.shape[1], x.device))
        self.counts["calls"] += 1
        self.counts["image_tokens"] = img.shape[1]
        self.counts["text_tokens"] = txt.shape[1]
        return flow_to_vp(x, unpack(v_flow.float(), *hw),
                          tf.reshape(-1, 1, 1, 1), s)
