"""The plain reference of the SV3D_p configuration, in f32: its video UNet,
its noise table and vector conditioning, the geometry of the orbit's
frames, and one SDS step over the orbit.

It follows sv3d_p.yaml's network (model_channels 320, channel_mult
1/2/4/4, 2 res blocks, attention at the first three levels, heads of 64
channels, context 1024, 8 input channels, adm 1280) as sgm's VideoUNet
computes it: each ResBlock is followed by its `time_stack` (a ResBlock of
(3, 1, 1) Conv3d over (B, C, T, h, w), GroupNorm over C/32 channels of all
frames, the frame's embedding between the convolutions) and mixed with it
as a x + (1 - a) (x + time_stack(x)), a = sigmoid(mix_factor); each spatial
transformer's tokens, plus an MLP of the frame index's sinusoid, go
through a VideoTransformerBlock over the frames (ff_in, self-attention,
cross-attention to the first frame's context, ff) and are mixed likewise
before proj_out. The noise is the EDM table (1000 sigmas from 0.002 to 700,
rho 7, ascending) read as the VP table alpha_bar = 1 / (1 + sigma^2), with
c_noise = ln(sigma) / 4 as the UNet's time. Guidance is two-branch CFG, the
unconditional branch with the condition latent and the context zeroed.

The step: the NeRF2D texture field over the frames' UVs, the composite on
white, the VAE encode and posterior sample of every frame, the sampled
frame's render and encode again with the gradient, grafted into its
latent; VP noising at index t, the CFG v-prediction, the v-target, the SDS
target and the 1/2-sum-square loss over the sampled frame; the backward
and an Adam step. Spatial attention runs a block of frames at a time, and
the VAE encodes a few frames at a time, so that f32 fits the card; every
frame is independent there, so the blocks change nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import geometry as geo
from portbench.reference.layers import (BasicTransformerBlock, Conv,
                                        CrossAttention, Dense, Downsample2D,
                                        FeedForward, GroupNormSiLU,
                                        LayerNormF32, ResnetBlock2D,
                                        TimestepEmbedding, Upsample2D,
                                        timestep_embedding)
from portbench.reference.sds import (GRAD_SCALE, colors, crop_and_resize,
                                     dreamtime_schedule)
from portbench.reference.towers import encode_moments

NUM_IDX, SIGMA_MIN, SIGMA_MAX, RHO = 1000, 0.002, 700.0, 7.0
ATTN_ELEMENTS = 2 ** 28  # f32 logits a block of frames holds at most
ENCODE_FRAMES = 4  # frames a VAE encode takes at once
WHITE = 1.0


# -- the noise table and the conditioning ------------------------------------------

def sigmas(device=None) -> torch.Tensor:
    i = torch.arange(NUM_IDX, dtype=torch.float64)
    ramp = (NUM_IDX - 1 - i) / (NUM_IDX - 1)
    lo, hi = SIGMA_MIN ** (1 / RHO), SIGMA_MAX ** (1 / RHO)
    return ((hi + ramp * (lo - hi)) ** RHO).float().to(device)


def alphas_cumprod(device=None) -> torch.Tensor:
    s = sigmas().double()
    return (1.0 / (1.0 + s * s)).float().to(device)


def c_noise(device=None) -> torch.Tensor:
    return (0.25 * torch.log(sigmas().double())).float().to(device)


def schedule(total_iterations: int) -> List[int]:
    return dreamtime_schedule(alphas_cumprod(), total_iterations)


def orbit_degrees(frames: int, elevation_deg: float):
    """(elevations, azimuths) in degrees: azimuths 360 k / T, k = 1..T."""
    az = [(360.0 * k / frames) % 360.0 for k in range(1, frames + 1)]
    return [elevation_deg] * frames, az


def vector_y(frames: int, elevation_deg: float, cond_aug: float,
             device=None) -> torch.Tensor:
    """(T, 1280): [sin(cond_aug, 256), sin(polar, 512), sin(azimuth, 512)],
    polar = 90 - elevation, azimuth relative to the last frame's."""
    elev, az = orbit_degrees(frames, elevation_deg)
    polar = torch.tensor([math.radians(90.0 - e) for e in elev])
    azr = torch.tensor([math.radians((a - az[-1]) % 360.0) for a in az])
    aug = torch.full((frames,), float(cond_aug))
    return torch.cat([timestep_embedding(aug, 256),
                      timestep_embedding(polar, 512),
                      timestep_embedding(azr, 512)], dim=-1).to(device)


# -- the network -----------------------------------------------------------------------

class VideoUNetConfig:
    def __init__(self, in_channels=8, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2, cross_attention_dim=1024,
                 num_heads=(5, 10, 20, 20), transformer_depth=1,
                 adm_in_channels=1280, frames=21):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        self.num_heads = tuple(num_heads)
        self.transformer_depth = transformer_depth
        self.adm_in_channels = adm_in_channels
        self.frames = frames

    @staticmethod
    def tiny():
        return VideoUNetConfig(block_out_channels=(32, 64),
                               layers_per_block=1, cross_attention_dim=32,
                               num_heads=(2, 4), frames=5)

    def is_cross(self, bi: int) -> bool:
        return bi < len(self.block_out_channels) - 1


class Mixer(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, spatial, temporal):
        a = torch.sigmoid(self.mix_factor.float())
        return a * spatial + (1.0 - a) * temporal


class TimeStack(nn.Module):
    def __init__(self, c: int, temb: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(c, 32, 1e-5)
        self.conv1 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = Dense(temb, c)
        self.norm2 = GroupNormSiLU(c, 32, 1e-5)
        self.conv2 = nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, emb):
        """x (B, C, T, h, w), emb (B, T, E) -> x + the branch."""
        h = self.conv1(self.norm1(x))
        e = self.time_emb_proj(F.silu(emb))
        h = h + e.permute(0, 2, 1)[..., None, None]
        return x + self.conv2(self.norm2(h))


class VideoResBlock(ResnetBlock2D):
    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__(cin, cout, temb_dim=temb)
        self.time_stack = TimeStack(cout, temb)
        self.time_mixer = Mixer()

    def forward(self, x, emb, frames):
        x = super().forward(x, emb)
        BT, C, h, w = x.shape
        B = BT // frames
        u = x.reshape(B, frames, C, h, w).permute(0, 2, 1, 3, 4)
        r = self.time_stack(u, emb.reshape(B, frames, -1))
        out = self.time_mixer(u, r)
        return out.permute(0, 2, 1, 3, 4).reshape(BT, C, h, w)


class VideoTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm_in = LayerNormF32(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, dim, heads, dim // heads)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, dim // heads)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx_first, frames):
        BT, S, C = x.shape
        B = BT // frames
        a = x.reshape(B, frames, S, C).permute(0, 2, 1, 3).reshape(
            B * S, frames, C)
        a = a + self.ff_in(self.norm_in(a))
        a = a + self.attn1(self.norm1(a))
        ctx = ctx_first[:, None].expand(B, S, *ctx_first.shape[1:]).reshape(
            B * S, *ctx_first.shape[1:])
        a = a + self.attn2(self.norm2(a), context=ctx)
        a = a + self.ff(self.norm3(a))
        return a.reshape(B, S, frames, C).permute(0, 2, 1, 3).reshape(BT, S,
                                                                      C)


class SpatialVideoTransformer(nn.Module):
    def __init__(self, c: int, heads: int, ctx_dim: int):
        super().__init__()
        self.heads = heads
        self.norm = GroupNormSiLU(c, 32, 1e-6, act=False)
        self.proj_in = Dense(c, c)
        self.proj_out = Dense(c, c)
        self.transformer_blocks_0 = BasicTransformerBlock(c, heads,
                                                          c // heads, ctx_dim)
        self.time_stack_0 = VideoTransformerBlock(c, heads, ctx_dim)
        self.time_pos_embed = TimestepEmbedding(c, 4 * c)
        self.time_pos_embed.linear_2 = Dense(4 * c, c)
        self.time_mixer = Mixer()

    def forward(self, x, context, frames):
        BT, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(BT, H * W,
                                                                  C))
        # the spatial block a few frames at a time: each frame is on its own
        n = max(1, ATTN_ELEMENTS // (self.heads * (H * W) ** 2))
        h = torch.cat([self.transformer_blocks_0(h[i:i + n],
                                                 context=context[i:i + n])
                       for i in range(0, BT, n)])
        pos = self.time_pos_embed(timestep_embedding(
            torch.arange(frames, device=x.device), C))
        pos = pos.repeat(BT // frames, 1)[:, None, :]
        a = self.time_stack_0(h + pos, context[::frames], frames)
        h = self.time_mixer(h, a)
        h = self.proj_out(h).reshape(BT, H, W, C).permute(0, 3, 1, 2)
        return x + h


class VideoUNet(nn.Module):
    def __init__(self, cfg: VideoUNetConfig):
        super().__init__()
        self.config = cfg
        c0 = cfg.block_out_channels[0]
        temb = 4 * c0
        nb = len(cfg.block_out_channels)
        self.time_embedding = TimestepEmbedding(c0, temb)
        self.label_emb = TimestepEmbedding(cfg.adm_in_channels, temb)
        self.conv_in = Conv(cfg.in_channels, c0, 3, padding=1)
        ch, res = c0, [c0]
        for bi, out in enumerate(cfg.block_out_channels):
            for li in range(cfg.layers_per_block):
                setattr(self, f"down_{bi}_resnet_{li}",
                        VideoResBlock(ch, out, temb))
                ch = out
                if cfg.is_cross(bi):
                    setattr(self, f"down_{bi}_attn_{li}",
                            SpatialVideoTransformer(out, cfg.num_heads[bi],
                                                    cfg.cross_attention_dim))
                res.append(out)
            if bi < nb - 1:
                setattr(self, f"down_{bi}_downsample", Downsample2D(out))
                res.append(out)
        self.mid_resnet_0 = VideoResBlock(ch, ch, temb)
        self.mid_attn = SpatialVideoTransformer(ch, cfg.num_heads[-1],
                                                cfg.cross_attention_dim)
        self.mid_resnet_1 = VideoResBlock(ch, ch, temb)
        for bi in reversed(range(nb)):
            out = cfg.block_out_channels[bi]
            for li in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{bi}_resnet_{li}",
                        VideoResBlock(ch + res.pop(), out, temb))
                ch = out
                if cfg.is_cross(bi):
                    setattr(self, f"up_{bi}_attn_{li}",
                            SpatialVideoTransformer(out, cfg.num_heads[bi],
                                                    cfg.cross_attention_dim))
            if bi > 0:
                setattr(self, f"up_{bi}_upsample", Upsample2D(out))
        self.conv_norm_out = GroupNormSiLU(c0, 32, 1e-5)
        self.conv_out = Conv(c0, cfg.out_channels, 3, padding=1)

    def forward(self, x, cn, context, y):
        """x (B T, 8, h, w); cn (1,) or (B T,) c_noise; context (B T, L,
        ctx); y (B T, adm)."""
        cfg, T = self.config, self.config.frames
        c0 = cfg.block_out_channels[0]
        emb = self.time_embedding(timestep_embedding(cn.reshape(-1), c0)) + \
            self.label_emb(y)
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
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h, emb, T),
                                            context, T), emb, T)
        for bi in reversed(range(nb)):
            for li in range(cfg.layers_per_block + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = getattr(self, f"up_{bi}_resnet_{li}")(h, emb, T)
                if cfg.is_cross(bi):
                    h = getattr(self, f"up_{bi}_attn_{li}")(h, context, T)
            if bi > 0:
                h = getattr(self, f"up_{bi}_upsample")(h)
        return self.conv_out(self.conv_norm_out(h))


def cfg_v_pred(unet: VideoUNet, latents_noisy, t: int, z_cond, context, y,
               guidance: float):
    """Two-branch CFG over the T frames in one call at batch 2 T: the
    unconditional branch (first) has z_cond and the context zeroed."""
    T = latents_noisy.shape[0]
    cn = c_noise(latents_noisy.device)[int(t)].reshape(1)
    zc = z_cond.expand(T, -1, -1, -1)
    ctx = context.expand(T, -1, -1)
    x = torch.cat([torch.cat([latents_noisy, torch.zeros_like(zc)], dim=1),
                   torch.cat([latents_noisy, zc], dim=1)])
    v_u, v_c = unet(x, cn, torch.cat([torch.zeros_like(ctx), ctx]),
                    torch.cat([y, y])).chunk(2)
    return v_u + guidance * (v_c - v_u)


# -- the orbit's frames ----------------------------------------------------------------

def orbit_frames(obj_path, render_px: int, frame_px: int, frames: int,
                 elevation_deg: float, shape_scale: float, dy: float,
                 radius: float, device) -> Dict:
    """The orbit's views of the mesh at render_px^2, each cropped to its
    object box and resized to frame_px^2: uv_pts (T P^2, 2) (the
    mask-weighted UVs over the mask), mask_frames (T, 1, P, P)."""
    verts, faces, vt, ft = geo.read_obj(obj_path)
    verts = torch.from_numpy(geo.normalize(verts, shape_scale, dy)).to(device)
    faces = torch.from_numpy(faces).to(device)
    elev, az = orbit_degrees(frames, elevation_deg)
    M = geo.camera_transforms([math.radians(90 - e) for e in elev],
                              [math.radians(a) for a in az], radius, dy,
                              device)
    ones = torch.ones((verts.shape[0], 1), device=device)
    vc = torch.einsum("nk,bkj->bnj", torch.cat([verts, ones], -1), M)
    tanf = math.tan(geo.FOVY / 2)
    pr = vc * torch.tensor([1 / tanf, 1 / tanf, -1.0], device=device)
    fvi = (pr[..., :2] / pr[..., 2:3])[:, faces]
    face_idx, bary = geo.rasterize(vc[:, faces][..., 2], fvi, render_px,
                                   render_px)
    masks = (face_idx > -1).float()[:, None]
    uv_attr = torch.from_numpy(vt[ft]).to(device)[None].expand(
        frames, -1, -1, -1)
    uv = geo.interpolate(face_idx, bary, uv_attr).permute(0, 3, 1, 2)
    uvs, ms = [], []
    for i in range(frames):
        box = geo.nonzero_box(masks[i, 0].cpu().numpy())
        m = crop_and_resize(masks[i:i + 1], box, frame_px, frame_px)
        uvs.append(crop_and_resize(uv[i:i + 1] * masks[i:i + 1], box,
                                   frame_px, frame_px) / m.clamp(min=1e-6))
        ms.append(m)
    uv_pts = torch.cat(uvs).permute(0, 2, 3, 1).reshape(-1, 2)
    return {"uv_pts": uv_pts.clamp(0.0, 1.0).contiguous(),
            "mask_frames": torch.cat(ms)}


# -- the SDS step ------------------------------------------------------------------------

class OrbitSDSReference:
    """`towers` = (VideoUNet, VAE Encoder) in f32; `mlp` a NeRF2D in f32;
    `inputs`: uv_pts, mask_frames, z_cond (1, 4, h, w), context (1, 1,
    ctx); `orbit` (frames, elevation_deg, cond_aug, guidance); `optim`
    (lr, betas, eps)."""

    def __init__(self, towers, mlp, inputs: Dict, frame_px: int, vae_config,
                 orbit: Tuple[int, float, float, float],
                 optim: Tuple[float, Sequence[float], float]):
        self.unet, self.vae = towers
        self.mlp = mlp
        self.inp = inputs
        self.P = frame_px
        self.vae_config = vae_config
        self.frames, elevation_deg, cond_aug, self.guidance = orbit
        dev = inputs["uv_pts"].device
        self.acp = alphas_cumprod(dev)
        self.y = vector_y(self.frames, elevation_deg, cond_aug, dev)
        lr, betas, eps = optim
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=lr,
                                          betas=tuple(betas), eps=eps)

    def _frames(self, rgb, mask):
        img = rgb.reshape(-1, self.P, self.P, 3).permute(0, 3, 1, 2)
        img = torch.clamp(img * mask + WHITE * (1 - mask), 0.0, 1.0)
        return img * 2 - 1

    def _encode(self, img, eps):
        outs = []
        for i in range(0, img.shape[0], ENCODE_FRAMES):
            mean, logvar = encode_moments(self.vae, img[i:i + ENCODE_FRAMES])
            outs.append((mean + torch.exp(0.5 * logvar)
                         * eps[i:i + ENCODE_FRAMES])
                        * self.vae_config.scaling_factor)
        return torch.cat(outs)

    def step(self, t: int, d: Dict) -> Dict:
        """One step on the draws d (tile_idx, eps, noise); returns the
        loss, each leaf's gradient and the Fisher divergence of all the
        frames."""
        f = int(d["tile_idx"])
        eps, noise = d["eps"].float(), d["noise"].float()
        n = self.P * self.P
        uv, mask = self.inp["uv_pts"], self.inp["mask_frames"]
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            z_full = self._encode(self._frames(colors(self.mlp, uv), mask),
                                  eps)
        patch = self._frames(colors(self.mlp, uv[f * n:(f + 1) * n]),
                             mask[f:f + 1])
        z_f = self._encode(patch, eps[f:f + 1])
        z = z_full.clone()
        z[f:f + 1] = z_full[f:f + 1] + (z_f - z_f.detach())
        z_sg = z.detach()
        a = self.acp[int(t)]
        with torch.no_grad():
            noisy = torch.sqrt(a) * z_sg + torch.sqrt(1 - a) * noise
            v_pred = cfg_v_pred(self.unet, noisy, t, self.inp["z_cond"],
                                self.inp["context"], self.y, self.guidance)
        v = torch.sqrt(a) * noise - torch.sqrt(1 - a) * z_sg
        g = torch.nan_to_num(GRAD_SCALE * (1 - a) * torch.sqrt(a)
                             * (v_pred - v))
        targets = (z_sg - g).detach()
        loss = 0.5 * torch.sum((z[f] - targets[f]) ** 2)
        loss.backward()
        grads = {k: p.grad.detach().clone()
                 for k, p in self.mlp.named_parameters()}
        self.optimizer.step()
        fisher = torch.sum((torch.sqrt(a) / torch.clamp(torch.sqrt(1 - a),
                                                        min=1e-8)) ** 2
                           * (v_pred - v) ** 2)
        return {"loss": float(loss.detach()), "grads": grads,
                "fisher": float(fisher), "v_pred": v_pred}

