"""The Zero123++ SDS teacher: UNet with reference attention + depth
ControlNet + the VAE encoder + the CLIP text and vision towers, and the
latent/image scalings.

Counterpart of contexture_nerf_tpu/diffusion/zero123plus.py
(`scale_latents` ... `unscale_image`, `default_ramping_coefficients`, and
`Zero123PlusPipeline`'s `encode_condition_image`, `prepare_conditioning`,
`embed_control_cond`, `_cfg_core`, `_cfg_v_pred`, `_cfg_v_pred_individual`).
The conditioning takes its two VAE posterior draws as tensors, so a test
can feed the reference's. Towers with a local diffusers checkpoint
(`Zero123PlusWeightPaths`) load it through diffusion/weights.py, and the
ramping coefficients come from the snapshot's model_index.json.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion import weights as W
from contexture_nerf_tpu_torch.diffusion.clip import (
    CLIPTextConfig, CLIPTextModel, CLIPTokenizer, CLIPVisionConfig,
    CLIPVisionModelWithProjection)
from contexture_nerf_tpu_torch.diffusion.controlnet import (ControlNet,
                                                            embed_cond)
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Encoder, VAEConfig,
                                                     encode_moments,
                                                     sample_gaussian)
from contexture_nerf_tpu_torch.ops.image import resize_linear

# CLIP image normalization (the feature extractor's mean and std)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def scale_latents(latents):
    return (latents - 0.22) * 0.75


def unscale_latents(latents):
    return latents / 0.75 + 0.22


def scale_image(image):
    return image * 0.5 / 0.8


def unscale_image(image):
    return image / 0.5 * 0.8


def default_ramping_coefficients(n_tokens: int = 77) -> np.ndarray:
    """Per-token weights of the CLIP image embedding in the prompt
    embedding. Zero123++ v1.1 learns them; without its checkpoint, a linear
    ramp over the tokens, as the reference defaults to."""
    return np.linspace(0.0, 1.0, n_tokens, dtype=np.float32)


def load_ramping(path: Optional[str], n_tokens: int) -> np.ndarray:
    """The ramping coefficients of a json file: a plain list, or a dict
    with a "ramping_coefficients" key (a Zero123++ snapshot's
    model_index.json). A dict without the key, or no file, gives the
    default ramp (with a warning for the dict); a length other than
    n_tokens raises."""
    data = None
    if path:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("ramping_coefficients")
            if data is None:
                warnings.warn(f"{path} has no 'ramping_coefficients' key; "
                              "using the default linear ramp")
    if data is None:
        return default_ramping_coefficients(n_tokens)
    ramping = np.asarray(data, np.float32)
    if ramping.shape[0] != n_tokens:
        raise ValueError(f"ramping_coefficients length {ramping.shape[0]} "
                         f"!= max_positions {n_tokens}")
    return ramping


@dataclass
class Zero123PlusWeightPaths:
    """Local checkpoint directories (diffusers layout) of the teacher; all
    optional. `ramping_coefficients` is a json file (see load_ramping)."""

    unet: Optional[str] = None
    vae: Optional[str] = None
    controlnet: Optional[str] = None
    text_encoder: Optional[str] = None
    vision_encoder: Optional[str] = None
    tokenizer_vocab: Optional[str] = None
    tokenizer_merges: Optional[str] = None
    ramping_coefficients: Optional[str] = None

    @staticmethod
    def from_snapshot(root: Optional[str] = None,
                      controlnet_root: Optional[str] = None
                      ) -> "Zero123PlusWeightPaths":
        """`root`, a Zero123++ snapshot (guide.zero123plus_path): its
        unet/, vae/, text_encoder/, vision_encoder/, tokenizer/,
        controlnet/ and model_index.json (the ramp); `controlnet_root`, a
        standalone ControlNet (guide.controlnet_path), which takes the
        place of root's controlnet/. What is missing stays None."""
        wp = Zero123PlusWeightPaths()
        if root is not None:
            root = Path(root)
            for attr in ("unet", "vae", "text_encoder", "vision_encoder",
                         "controlnet"):
                if (root / attr).exists():
                    setattr(wp, attr, str(root / attr))
            wp.tokenizer_vocab, wp.tokenizer_merges = W.snapshot_tokenizer(root)
            if (root / "model_index.json").exists():
                wp.ramping_coefficients = str(root / "model_index.json")
        if controlnet_root is not None:
            wp.controlnet = str(controlnet_root)
        return wp


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
    """UNet + ControlNet + VAE encoder + CLIP text and vision towers of the
    Zero123++ teacher, in one dtype: bf16 at full size, f32 at tiny size
    (as the reference's trainer chooses). `generator` fills the towers with
    seeded random weights; without it they keep torch's init (for a bridged
    load). Then each tower with a path in `weight_paths` loads it, and the
    tokenizer and the ramp come from the snapshot; `loaded` holds each
    loaded tower's path, bytes and seconds. `tile_px` is the side of one of
    the 3x2 grid's tiles."""

    CONDITIONING_SCALE = 2.0  # the depth ControlNet's, reference trainer

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weight_paths: Optional[Zero123PlusWeightPaths] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = torch.float32 if tiny else torch.bfloat16
        self.unet_config = (UNetConfig.tiny(in_channels=4) if tiny
                            else UNetConfig.zero123plus())
        self.vae_config = VAEConfig.tiny() if tiny else VAEConfig.sd()
        self.tile_px = 32 if tiny else 320
        if tiny:
            self.text_config = CLIPTextConfig.tiny()
            self.vision_config = CLIPVisionConfig.tiny()
            # the tiny image embedding is ramped into the tiny text width
            self.vision_config.projection_dim = self.text_config.hidden_size
        else:
            self.text_config = CLIPTextConfig.sd2()
            self.vision_config = CLIPVisionConfig.vit_h()
        with torch.device(dev):
            self.unet = UNet2DCondition(self.unet_config, self.dtype)
            self.controlnet = ControlNet(self.unet_config, self.dtype)
            self.vae_encoder = Encoder(self.vae_config, self.dtype)
            self.text_encoder = CLIPTextModel(self.text_config, self.dtype)
            self.vision_encoder = CLIPVisionModelWithProjection(
                self.vision_config, self.dtype)
        wp = weight_paths or Zero123PlusWeightPaths()
        self.tokenizer = CLIPTokenizer(
            vocab_path=wp.tokenizer_vocab, merges_path=wp.tokenizer_merges,
            vocab_size=self.text_config.vocab_size,
            max_length=self.text_config.max_positions)
        self.ramping = torch.from_numpy(load_ramping(
            wp.ramping_coefficients, self.text_config.max_positions)).to(dev)
        if generator is not None:
            random_init_(self, generator)
        self.to(self.dtype)
        self.requires_grad_(False)
        self.loaded = W.load_towers_([
            ("unet", self.unet, wp.unet, W.convert_unet, self.unet_config),
            ("controlnet", self.controlnet, wp.controlnet,
             W.convert_controlnet, self.unet_config),
            ("vae_encoder", self.vae_encoder, wp.vae, W.convert_vae,
             self.vae_config, "encoder"),
            ("text_encoder", self.text_encoder, wp.text_encoder,
             W.convert_clip_text, self.text_config),
            ("vision_encoder", self.vision_encoder, wp.vision_encoder,
             W.convert_clip_vision, self.vision_config)])
        self.alphas_cumprod = sch.make_alphas_cumprod(device=dev)

    # -- conditioning ------------------------------------------------------------

    @torch.no_grad()
    def encode_condition_image(self, image: torch.Tensor,
                               eps: torch.Tensor) -> torch.Tensor:
        """cond image (1,3,H,W) in [-1,1] -> an unscaled sample of its VAE
        posterior, mean + std * eps."""
        mean, logvar = encode_moments(self.vae_encoder, image)
        return sample_gaussian(mean, logvar, eps)

    @torch.no_grad()
    def encode_condition_pair(self, cond_image: torch.Tensor,
                              eps_cond: torch.Tensor, eps_neg: torch.Tensor
                              ) -> torch.Tensor:
        """(2,4,h,w) CFG latents [negative (an all-zero image), positive]."""
        cond_lat = self.encode_condition_image(cond_image, eps_cond)
        negative_lat = self.encode_condition_image(
            torch.zeros_like(cond_image), eps_neg)
        return torch.cat([negative_lat, cond_lat])

    @torch.no_grad()
    def clip_hidden_states(self, cond_image: torch.Tensor) -> torch.Tensor:
        """(2,77,ctx) encoder hidden states [empty prompt, empty prompt +
        ramped CLIP image embedding] of a cond image in [-1,1]."""
        dev = cond_image.device
        sz = self.vision_config.image_size
        x01 = resize_linear(cond_image.float() / 2 + 0.5, (sz, sz))
        mean = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=dev).reshape(1, 3, 1, 1)
        global_embeds = self.vision_encoder((x01 - mean) / std)[:, None, :]
        empty_ids = torch.from_numpy(self.tokenizer([""])).long().to(dev)
        text_embeds = self.text_encoder(empty_ids)
        cond_hidden = text_embeds + global_embeds * self.ramping.reshape(
            1, -1, 1)
        return torch.cat([text_embeds, cond_hidden])

    def prepare_conditioning(self, cond_image: torch.Tensor,
                             eps_cond: torch.Tensor, eps_neg: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cond_image (1,3,Hc,Wc) in [-1,1] -> (cond_lat_pair (2,4,h,w),
        encoder_hidden_states (2,77,ctx)), CFG pairs [negative, positive].
        eps_cond / eps_neg are the normal draws of the two VAE posterior
        samples."""
        return (self.encode_condition_pair(cond_image, eps_cond, eps_neg),
                self.clip_hidden_states(cond_image))

    # -- the SDS teacher ------------------------------------------------------------

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
