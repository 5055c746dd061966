"""The SV3D_p teacher (https://huggingface.co/stabilityai/sv3d, `sv3d_p`;
arXiv:2403.12008) for the SDS loop: the video UNet (video_unet.py), the SD
VAE encoder (128/256/512/512, scale 0.18215) and the OpenCLIP ViT-H/14
image tower, with the noise, the conditioning and the guidance of
generative-models' `scripts/sampling/configs/sv3d_p.yaml` and
`simple_video_sample.py`, as read for this port:

  - sigmas: the EDM discretization (n 1000, sigma_min 0.002, sigma_max 700,
    rho 7), flipped so that index 0 is sigma_min (DiscreteDenoiser's
    table). The SDS loop draws an index i of this table (DreamTime over the
    1000 indices) where the sampler walks a schedule of its own.
  - VScalingWithEDMcNoise: c_in = 1/sqrt(s^2+1), c_skip = 1/(s^2+1),
    c_out = -s/sqrt(s^2+1), c_noise = ln(s)/4. With
    alpha_bar = 1/(1+s^2), c_in (x0 + s n) is the VP latent
    sqrt(a) x0 + sqrt(1-a) n and the network's output is the VP
    v-prediction sqrt(a) n - sqrt(1-a) x0: the port's add_noise,
    velocity_target and SDS loss apply as they are, over this table's
    alpha_bar (`alphas_cumprod`). The UNet's timestep input is c_noise, a
    real number, not i (a DiscreteDenoiser with quantize_c_noise would
    pass an index; the yaml's network reads c_noise).
  - y, per frame: [sinusoid(cond_aug, 256), sinusoid(polar, 512),
    sinusoid(azimuth, 512)] (ConcatTimestepEmbedderND; cos first, max
    period 10000); polar = 90 deg - elevation; azimuths 360 k / T for
    k = 1..T, taken relative to the last (which is then 0: the front).
  - conditioning: the front image plus cond_aug times a normal draw, its
    VAE mode latent, unscaled, repeated over the frames as the UNet's
    extra 4 input channels; the clean image's CLIP image embedding
    (1 token, 1024 wide; resized to 224 bilinear with antialias, where
    OpenCLIP's preprocessing is bicubic) as the cross-attention context.
  - CFG: the unconditional branch zeroes the condition latent and the
    context (force_uc_zero_embeddings), y stays; v = v_u + s (v_c - v_u)
    with a constant scale (2.5, the maximum of the sampler's per-frame
    TrianglePredictionGuider).
  - frames composite on white, as SV3D's own inputs are.

Without a checkpoint the towers get seeded random weights; each blender's
mix_factor is drawn near SVD's initial 0.5, so that both halves carry
weight. SV3D's video decoder and sv3d_u are not part of the SDS step and
are left out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.diffusion.clip import (
    CLIPVisionConfig, CLIPVisionModelWithProjection)
from contexture_nerf_tpu_torch.diffusion.layers import (set_quant,
                                                        timestep_embedding)
from contexture_nerf_tpu_torch.diffusion.vae import (Encoder, VAEConfig,
                                                     encode_moments)
from contexture_nerf_tpu_torch.diffusion.video_unet import (VideoUNet,
                                                            VideoUNetConfig)
from contexture_nerf_tpu_torch.diffusion.zero123plus import (CLIP_MEAN,
                                                             CLIP_STD,
                                                             random_init_)
from contexture_nerf_tpu_torch.ops.image import resize_linear

NUM_IDX = 1000
SIGMA_MIN, SIGMA_MAX, RHO = 0.002, 700.0, 7.0
FRAMES = 21
FRAME_PX = 576
ELEVATION_DEG = 10.0
COND_AUG = 1e-5
GUIDANCE = 2.5
MIX_INIT, MIX_SPREAD = 0.5, 0.25  # blenders' mix_factor: 0.5 + 0.25 N(0, 1)
Y_WIDTHS = (256, 512, 512)  # cond_aug, polar, azimuth


def edm_sigmas(n: int = NUM_IDX, sigma_min: float = SIGMA_MIN,
               sigma_max: float = SIGMA_MAX, rho: float = RHO,
               device=None) -> torch.Tensor:
    """(n,) f32 EDM sigmas, ascending: index 0 is sigma_min."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float64)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sig = (hi + ramp * (lo - hi)) ** rho
    return torch.flip(sig, (0,)).float().to(device)


def alphas_cumprod(sigmas: torch.Tensor) -> torch.Tensor:
    """alpha_bar = 1 / (1 + sigma^2): the VP table of the EDM sigmas."""
    return 1.0 / (1.0 + sigmas.double() ** 2).float()


def c_noise(sigmas: torch.Tensor) -> torch.Tensor:
    return 0.25 * torch.log(sigmas.double()).float()


def orbit_angles(frames: int = FRAMES, elevation_deg: float = ELEVATION_DEG
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(polars, azimuths) in radians of the T frames, as
    simple_video_sample.py sets them for sv3d_p: elevation constant,
    azimuths 360 k / T (k = 1..T) relative to the last."""
    az_deg = np.linspace(0, 360, frames + 1)[1:] % 360
    az = np.deg2rad((az_deg - az_deg[-1]) % 360)
    polar = np.full(frames, np.deg2rad(90.0 - elevation_deg))
    return polar, az


def vector_conditioning(polars, azimuths, cond_aug: float = COND_AUG,
                        device=None) -> torch.Tensor:
    """(T, 1280) f32: each frame's [sinusoid(cond_aug, 256),
    sinusoid(polar, 512), sinusoid(azimuth, 512)]."""
    n = len(polars)
    cols = [torch.full((n,), float(cond_aug), dtype=torch.float32),
            torch.as_tensor(np.asarray(polars), dtype=torch.float32),
            torch.as_tensor(np.asarray(azimuths), dtype=torch.float32)]
    return torch.cat([timestep_embedding(c, w)
                      for c, w in zip(cols, Y_WIDTHS)], dim=-1).to(device)


@torch.no_grad()
def init_mixers_(unet: VideoUNet, generator: torch.Generator) -> None:
    for m in unet.mixers():
        m.mix_factor.copy_(MIX_INIT + MIX_SPREAD * torch.randn(
            m.mix_factor.shape, generator=generator,
            device=m.mix_factor.device))


class SV3DTeacher(nn.Module):
    """The SV3D_p towers in one dtype (bf16 at full size, f32 at tiny
    size): `unet` (VideoUNet), `vae_encoder`, `vision_encoder`. `frames`
    of `frame_px`^2 (21 of 576^2; tiny 5 of 32^2). `set_int8` turns W8A8
    on in the UNet (optim.int8_teacher). The towers are made from
    `generator`; `weight_paths` (a Zero123++ snapshot's) must be None:
    sv3d_p.safetensors has no loader yet."""

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weight_paths=None):
        super().__init__()
        if weight_paths is not None:
            raise ValueError("guide.teacher 'sv3d_p' makes its towers from "
                             "the seed: guide.zero123plus_path / "
                             "controlnet_path name Zero123++ weights")
        dev = resolve_device(device)
        self.dtype = torch.float32 if tiny else torch.bfloat16
        self.unet_config = (VideoUNetConfig.tiny() if tiny
                            else VideoUNetConfig.sv3d_p())
        self.vae_config = VAEConfig.tiny() if tiny else VAEConfig.sd()
        if tiny:
            self.vision_config = CLIPVisionConfig.tiny()
            self.vision_config.projection_dim = \
                self.unet_config.cross_attention_dim
        else:
            self.vision_config = CLIPVisionConfig.vit_h()
        self.frames = self.unet_config.frames
        self.frame_px = 32 if tiny else FRAME_PX
        self.elevation_deg, self.cond_aug = ELEVATION_DEG, COND_AUG
        self.guidance = GUIDANCE
        with torch.device(dev):
            self.unet = VideoUNet(self.unet_config, self.dtype)
            self.vae_encoder = Encoder(self.vae_config, self.dtype)
            self.vision_encoder = CLIPVisionModelWithProjection(
                self.vision_config, self.dtype)
        if generator is not None:
            random_init_(self, generator)
            init_mixers_(self.unet, generator)
        self.to(self.dtype)
        self.requires_grad_(False)
        self.make_tables(dev)
        self.set_int8()

    def make_tables(self, device) -> None:
        """The sigma, alpha_bar and c_noise tables and the frames' vector
        conditioning y, on `device` (a teacher built on the meta device
        makes them again where its weights go)."""
        self.sigmas = edm_sigmas(device=device)
        self.alphas_cumprod = alphas_cumprod(self.sigmas)
        self.c_noise = c_noise(self.sigmas)
        polar, az = orbit_angles(self.frames, self.elevation_deg)
        self.y = vector_conditioning(polar, az, self.cond_aug, device)

    def set_int8(self, int8_controlnet: bool = False,
                 int8_unet: bool = False) -> None:
        """W8A8 UNet with int8_unet (there is no ControlNet)."""
        self.int8_unet = bool(int8_unet)
        set_quant(self.unet, self.int8_unet)

    @torch.no_grad()
    def encode_condition(self, image: torch.Tensor, eps_aug: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The front image (1, 3, P, P) in [-1, 1] -> (z_cond (1, 4, P/8,
        P/8), the VAE mode of image + cond_aug eps_aug, unscaled; context
        (1, 1, ctx), the clean image's CLIP image embedding)."""
        dev = image.device
        mean, _ = encode_moments(self.vae_encoder,
                                 image + self.cond_aug * eps_aug.to(image))
        sz = self.vision_config.image_size
        x01 = resize_linear(image.float() / 2 + 0.5, (sz, sz))
        m = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 3, 1, 1)
        s = torch.tensor(CLIP_STD, device=dev).reshape(1, 3, 1, 1)
        ctx = self.vision_encoder((x01 - m) / s)[:, None, :]
        return mean.to(self.dtype), ctx.to(self.dtype)

    @torch.no_grad()
    def teacher_v_pred(self, latents_noisy: torch.Tensor, t: torch.Tensor,
                       z_cond: torch.Tensor, context: torch.Tensor,
                       guidance_scale: float = GUIDANCE) -> torch.Tensor:
        """The CFG v-prediction of the T frames (T, 4, h, w), VP-noised
        to index t of the sigma table: one UNet call at batch 2 T,
        [unconditional (zero z_cond and context); conditional]."""
        T = latents_noisy.shape[0]
        dt = self.dtype
        zc = z_cond.to(dt).expand(T, -1, -1, -1)
        x = torch.cat([latents_noisy.to(dt)] * 2)
        cond = torch.cat([torch.zeros_like(zc), zc])
        ctx = context.to(dt).expand(T, -1, -1)
        ctx = torch.cat([torch.zeros_like(ctx), ctx])
        y = torch.cat([self.y] * 2)
        t = torch.as_tensor(t, device=x.device).reshape(-1)
        v = self.unet(torch.cat([x, cond], dim=1), self.c_noise[t], ctx, y)
        v_u, v_c = v.chunk(2)
        return v_u + guidance_scale * (v_c - v_u)

