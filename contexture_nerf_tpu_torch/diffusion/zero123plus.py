"""The Zero123++ SDS teacher: UNet with reference attention + depth
ControlNet + the VAE encoder, and the latent/image scalings.

Counterpart of contexture_nerf_tpu/diffusion/zero123plus.py
(`scale_latents` ... `unscale_image`, and `Zero123PlusPipeline`'s
`embed_control_cond`, `_cfg_core`, `_cfg_v_pred`,
`_cfg_v_pred_individual`). The CLIP towers, the tokenizer and
`prepare_conditioning` belong to `prepare_sds` and wait for that slice; the
teacher takes `cond_lat_pair` and `encoder_hidden_states` as inputs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion.controlnet import (ControlNet,
                                                            embed_cond)
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import Encoder, VAEConfig


def scale_latents(latents):
    return (latents - 0.22) * 0.75


def unscale_latents(latents):
    return latents / 0.75 + 0.22


def scale_image(image):
    return image * 0.5 / 0.8


def unscale_image(image):
    return image / 0.5 * 0.8


def resize_linear(x: torch.Tensor, hw) -> torch.Tensor:
    """jax.image.resize(method="linear") on NCHW: half-pixel bilinear that
    antialiases when it downsamples (hence antialias=True), computed in
    f32."""
    y = F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for towers without a checkpoint: weights
    N(0, 1/fan_in), biases 0, norm weights 1 (the JAX package's fast tiny
    init). Zero-initialized heads get random values too, so a random
    ControlNet is not a no-op."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        is_norm = any(s in name for s in ("norm", "group_norm"))
        if leaf == "bias":
            p.zero_()
        elif is_norm:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    * fan_in ** -0.5)


class Zero123PlusTeacher(nn.Module):
    """UNet + ControlNet + VAE encoder of the Zero123++ teacher, in one
    dtype: bf16 at full size, f32 at tiny size (as the reference's
    trainer chooses). `generator` fills the towers with seeded random
    weights; without it they keep torch's init (for a bridged load)."""

    CONDITIONING_SCALE = 2.0  # the depth ControlNet's, reference trainer

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = torch.float32 if tiny else torch.bfloat16
        self.unet_config = (UNetConfig.tiny(in_channels=4) if tiny
                            else UNetConfig.zero123plus())
        self.vae_config = VAEConfig.tiny() if tiny else VAEConfig.sd()
        with torch.device(dev):
            self.unet = UNet2DCondition(self.unet_config, self.dtype)
            self.controlnet = ControlNet(self.unet_config, self.dtype)
            self.vae_encoder = Encoder(self.vae_config, self.dtype)
        if generator is not None:
            random_init_(self, generator)
        self.to(self.dtype)
        self.requires_grad_(False)
        self.alphas_cumprod = sch.make_alphas_cumprod(device=dev)

    def embed_control_cond(self, depth_image, latent_hw):
        """ControlNet hint embedding of a depth image (B,3,H,W), resized to
        8x the latent grid (antialiased when it shrinks)."""
        th, tw = latent_hw[0] * 8, latent_hw[1] * 8
        if tuple(depth_image.shape[2:]) != (th, tw):
            depth_image = resize_linear(depth_image, (th, tw))
        return embed_cond(self.controlnet, depth_image)

    @torch.no_grad()
    def _cfg_core(self, latents, t, branch_cond_lats, branch_ehs,
                  depth_image, neg_noise, cond_noise,
                  cn_cond_emb=None) -> List[torch.Tensor]:
        """Reference-attention UNet + depth ControlNet over nb CFG branches;
        per-branch v-predictions (B,4,H,W). Write-pass noise: `neg_noise`
        for the negative branch (row 0), `cond_noise` shared by the rest."""
        B = latents.shape[0]
        nb = branch_cond_lats.shape[0]
        branch_noise = torch.stack([neg_noise] + [cond_noise] * (nb - 1)).to(
            branch_cond_lats.dtype)
        cond_lats = branch_cond_lats.repeat_interleave(B, dim=0)
        ehs = branch_ehs.repeat_interleave(B, dim=0)
        noise = branch_noise.repeat_interleave(B, dim=0)
        lat_in = torch.cat([latents] * nb)  # DDPM: no input scaling

        th, tw = latents.shape[2] * 8, latents.shape[3] * 8
        if cn_cond_emb is None and tuple(depth_image.shape[2:]) != (th, tw):
            depth_image = resize_linear(depth_image, (th, tw))

        t = torch.as_tensor(t, device=latents.device).reshape(-1)
        noisy_cond = sch.add_noise(self.alphas_cumprod, cond_lats, noise,
                                   t.expand(cond_lats.shape[0]))
        ref: list = []
        self.unet(noisy_cond, t, ehs, ref_out=ref)

        depth_all = torch.cat([depth_image] * nb) if cn_cond_emb is None \
            else None
        emb_all = None if cn_cond_emb is None else \
            torch.cat([cn_cond_emb] * nb)
        downs, mid = self.controlnet(lat_in, t, ehs, depth_all,
                                     self.CONDITIONING_SCALE,
                                     cond_embedding=emb_all)
        v = self.unet(lat_in, t, ehs, down_residuals=downs,
                      mid_residual=mid, ref_kv_list=ref)
        return list(v.chunk(nb, dim=0))

    def _cfg_v_pred(self, latents, t, cond_lat_pair, encoder_hidden_states,
                    depth_image, guidance_scale, neg_noise, cond_noise,
                    cn_cond_emb=None):
        """Two-branch CFG: v_u + g (v_c - v_u)."""
        v_uncond, v_cond = self._cfg_core(
            latents, t, cond_lat_pair, encoder_hidden_states, depth_image,
            neg_noise, cond_noise, cn_cond_emb)
        return v_uncond + guidance_scale * (v_cond - v_uncond)

    def _cfg_v_pred_individual(self, latents, t, cond_lat_pair,
                               encoder_hidden_states, depth_image,
                               guidance_scale_i, guidance_scale_t,
                               neg_noise, cond_noise, cn_cond_emb=None):
        """Three-branch CFG (uncond, image-only, full):
        v_u + gs_i (v_img - v_u) + gs_t (v_full - v_img)."""
        neg_lat, cond_lat = cond_lat_pair.chunk(2, dim=0)
        uncond_e, cond_e = encoder_hidden_states.chunk(2, dim=0)
        v_u, v_img, v_full = self._cfg_core(
            latents, t, torch.cat([neg_lat, cond_lat, cond_lat]),
            torch.cat([uncond_e, uncond_e, cond_e]), depth_image,
            neg_noise, cond_noise, cn_cond_emb)
        return (v_u + guidance_scale_i * (v_img - v_u)
                + guidance_scale_t * (v_full - v_img))
