"""SD2-depth guidance: the text embedding, the depth-conditioned img2img
that bootstraps (and repaints) the front view, txt2img and the SDS
gradient.

Counterpart of contexture_nerf_tpu/diffusion/sd_depth.py
`StableDiffusionDepth` (all of it: `get_text_embeds`, `encode_imgs`,
`decode_latents`, `img2img_step` with all of `_build_img2img`,
`img2img_single_step`, `produce_latents`, `prompt_to_img`, `sds_grad`,
`load_concept`). The
reference compiles the 50-step PNDM loop into one graph (a scan, with a
`lax.cond` between the depth UNet and the 9-channel inpaint UNet at
10 < i < 20); here it is a host loop and the cond a Python `if`. The
random draws of the loop (the two VAE posterior draws, the initial latent
and the blending noise) are tensors a caller may pass, so a test can feed
the reference's `jax.random` draws. Encodes whose result the path discards
(the ground-truth latent without blending or noised_gt_init, the masked
latent without the inpaint branch) are skipped, as XLA drops them.

Towers with a local diffusers checkpoint (`SDWeightPaths`) load it through
diffusion/weights.py; the others keep seeded random weights.
`load_concept` adds a textual-inversion concept. `produce_latents` and
`sds_grad` take their draws (the initial latent; t and the noise) as
tensors too, and draw them from a generator otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch import phase, resolve_device
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion import weights as W
from contexture_nerf_tpu_torch.diffusion.clip import (CLIPTextConfig,
                                                      CLIPTextModel,
                                                      CLIPTokenizer)
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Decoder, Encoder,
                                                     VAEConfig, decode,
                                                     encode_moments,
                                                     sample_gaussian)
from contexture_nerf_tpu_torch.diffusion.zero123plus import random_init_
from contexture_nerf_tpu_torch.ops.image import (resize_bicubic,
                                                 resize_linear,
                                                 resize_nearest)

SD_VAE_SCALE = 0.18215
DRAWS = ("eps_enc", "eps_enc2", "latents", "noise")  # the reference's order


@dataclass
class SDWeightPaths:
    """Local checkpoint directories (diffusers layout); all optional."""

    unet: Optional[str] = None
    inpaint_unet: Optional[str] = None
    vae: Optional[str] = None
    text_encoder: Optional[str] = None
    tokenizer_vocab: Optional[str] = None
    tokenizer_merges: Optional[str] = None

    @staticmethod
    def from_snapshot(root: Optional[str] = None,
                      inpaint_root: Optional[str] = None) -> "SDWeightPaths":
        """`root`, an SD2-depth snapshot (guide.diffusion_name when it is a
        local directory): its unet/, vae/, text_encoder/ and tokenizer/.
        `inpaint_root`, an SD2-inpaint snapshot (guide.inpaint_model_path):
        its unet/, or the directory itself when it has none. A subfolder
        that is missing stays None (random weights)."""
        wp = SDWeightPaths()
        if root is not None:
            root = Path(root)
            for attr in ("unet", "vae", "text_encoder"):
                if (root / attr).exists():
                    setattr(wp, attr, str(root / attr))
            wp.tokenizer_vocab, wp.tokenizer_merges = W.snapshot_tokenizer(root)
        if inpaint_root is not None:
            ip = Path(inpaint_root)
            wp.inpaint_unet = str(ip / "unet" if (ip / "unet").exists()
                                  else ip)
        return wp


class StableDiffusionDepth(nn.Module):
    """SD2-depth UNet (5 channels), SD2-inpaint UNet (9 channels), the SD
    VAE (encoder and decoder), the SD2 CLIP text tower and its tokenizer,
    and the PNDM scheduler. bf16 at full size, f32 at tiny size, as the
    reference's trainer chooses. `generator` fills the towers with seeded
    random weights; without it they keep torch's init (for a bridged
    load). Then each tower with a path in `weight_paths` loads it, and the
    tokenizer reads the snapshot's vocab; `loaded` holds each loaded
    tower's path, bytes and seconds. `sds_grad` draws t from
    [min_timestep, max_timestep] of the 1000 training steps, and adds no
    noise with no_noise."""

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weight_paths: Optional[SDWeightPaths] = None,
                 min_timestep: float = 0.02, max_timestep: float = 0.98,
                 no_noise: bool = False):
        super().__init__()
        dev = self.device = resolve_device(device)
        self.num_train_timesteps = 1000
        self.min_step = int(self.num_train_timesteps * min_timestep)
        self.max_step = int(self.num_train_timesteps * max_timestep)
        self.no_noise = no_noise
        self.dtype = torch.float32 if tiny else torch.bfloat16
        if tiny:
            self.unet_config = UNetConfig.tiny(in_channels=5)
            self.inpaint_config = UNetConfig.tiny(in_channels=9)
            self.vae_config = VAEConfig.tiny()
            self.text_config = CLIPTextConfig.tiny()
        else:
            self.unet_config = UNetConfig.sd2_depth()
            self.inpaint_config = UNetConfig.sd2_inpaint()
            self.vae_config = VAEConfig.sd()
            self.text_config = CLIPTextConfig.sd2()
        with torch.device(dev):
            self.unet = UNet2DCondition(self.unet_config, self.dtype)
            self.inpaint_unet = UNet2DCondition(self.inpaint_config,
                                                self.dtype)
            self.vae_encoder = Encoder(self.vae_config, self.dtype)
            self.vae_decoder = Decoder(self.vae_config, self.dtype)
            self.text_encoder = CLIPTextModel(self.text_config, self.dtype)
        wp = weight_paths or SDWeightPaths()
        self.tokenizer = CLIPTokenizer(
            vocab_path=wp.tokenizer_vocab, merges_path=wp.tokenizer_merges,
            vocab_size=self.text_config.vocab_size,
            max_length=self.text_config.max_positions)
        if generator is not None:
            random_init_(self, generator)
        self.to(self.dtype)
        self.requires_grad_(False)
        self.loaded = W.load_towers_([
            ("unet", self.unet, wp.unet, W.convert_unet, self.unet_config),
            ("inpaint_unet", self.inpaint_unet, wp.inpaint_unet,
             W.convert_unet, self.inpaint_config),
            ("vae_encoder", self.vae_encoder, wp.vae, W.convert_vae,
             self.vae_config, "encoder"),
            ("vae_decoder", self.vae_decoder, wp.vae, W.convert_vae,
             self.vae_config, "decoder"),
            ("text_encoder", self.text_encoder, wp.text_encoder,
             W.convert_clip_text, self.text_config)])
        self.scheduler = sch.PNDM.create(self.num_train_timesteps, device=dev)
        self.alphas = self.scheduler.alphas_cumprod

    @property
    def image_size(self) -> int:
        """The side img2img works at: 512 for the SD2 widths, 64 at tiny
        size."""
        return 512 if self.unet_config.block_out_channels[0] >= 320 else 64

    # -- text ------------------------------------------------------------------

    @torch.no_grad()
    def get_text_embeds(self, prompts, negative_prompts=None) -> torch.Tensor:
        """[uncond; cond] CFG embedding pair (2N, 77, hidden), f32."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)

        def embed(p):
            ids = torch.from_numpy(self.tokenizer(p)).long().to(self.device)
            return self.text_encoder(ids)

        return torch.cat([embed(negative_prompts), embed(prompts)])

    def load_concept(self, concept_path: str) -> None:
        """A textual-inversion concept: a torch-saved dict of token ->
        embedding. Each embedding becomes a new row of the text tower's
        token table, and the token's id is that row (transformers'
        add_tokens + resize_token_embeddings)."""
        learned = torch.load(concept_path, map_location="cpu",
                             weights_only=True)
        for token, emb in learned.items():
            row = self.text_encoder.grow_tokens(emb.float().reshape(1, -1))
            self.tokenizer.add_token(token, row)

    # -- VAE -------------------------------------------------------------------

    @torch.no_grad()
    def encode_imgs(self, imgs: torch.Tensor, eps: torch.Tensor
                    ) -> torch.Tensor:
        """[0,1] images -> scaled latents, eps the posterior's normal
        draw."""
        mean, logvar = encode_moments(self.vae_encoder, 2 * imgs - 1)
        return sample_gaussian(mean, logvar, eps) * SD_VAE_SCALE

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents -> [0,1] images, in the VAE's dtype."""
        imgs = decode(self.vae_decoder, latents / SD_VAE_SCALE)
        return torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)

    # -- img2img ---------------------------------------------------------------

    def latent_shape(self) -> Tuple[int, ...]:
        lat = self.image_size // self.vae_config.downsample
        return (1, self.vae_config.latent_channels, lat, lat)

    def draw(self, seed: int) -> Dict[str, torch.Tensor]:
        """img2img's four normal draws (DRAWS), f32, from a generator seeded
        with `seed`."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return {k: torch.randn(self.latent_shape(), generator=g,
                               device=self.device) for k in DRAWS}

    @torch.no_grad()
    def img2img_step(self, text_embeddings, inputs, depth_mask,
                     guidance_scale: float = 7.5, strength: float = 1.0,
                     num_inference_steps: int = 50, update_mask=None,
                     fixed_seed: Optional[int] = None,
                     intermediate_vis: bool = False,
                     use_latent_blending: bool = False,
                     use_inpaint: bool = True,
                     draws: Optional[Dict[str, torch.Tensor]] = None,
                     timings: Optional[Dict[str, float]] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Depth-conditioned img2img. inputs (1,3,h,w) in [0,1], depth_mask
        (1,1,h,w) and update_mask (1,1,h,w) are crops of any size: the image
        is resized (linear) to image_size, the depth (bicubic) to the
        latent size, the mask (nearest) to both. strength runs the last
        int(n * strength) scheduler steps. Without an update mask the loop
        starts from the ground truth noised to the first kept timestep,
        otherwise from pure noise. `draws` (DRAWS, each of latent_shape())
        default to a generator seeded with fixed_seed (0 if None). With
        use_inpaint the inpaint UNet takes the steps 10 < i < 20.
        `timings`, when given, receives bootstrap_unet (resizes, encodes
        and the loop) and bootstrap_decode. Returns ([0,1] rgb (1,3,S,S),
        the intermediate images)."""
        dev = self.device
        S = self.image_size
        lat_sz = S // self.vae_config.downsample
        pndm = self.scheduler
        init_t = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_t, 0)
        timesteps = pndm.timesteps(num_inference_steps)[t_start:]
        if draws is None:
            draws = self.draw(0 if fixed_seed is None else fixed_seed)
        d = {k: draws[k].to(dev, torch.float32) for k in DRAWS}

        with phase(timings, "bootstrap_unet", dev):
            rgb = resize_linear(inputs.to(dev, torch.float32), (S, S))
            depth = resize_bicubic(depth_mask.to(dev, torch.float32),
                                   (lat_sz, lat_sz))
            noised_gt_init = update_mask is None
            if update_mask is None:
                update_mask = torch.ones((1, 1, S, S), device=dev)
            else:
                update_mask = resize_nearest(
                    update_mask.to(dev, torch.float32), (S, S))
            dmin, dmax = depth.min(), depth.max()
            depth = 2.0 * (depth - dmin) / torch.clamp(dmax - dmin,
                                                       min=1e-8) - 1.0
            depth_pair = torch.cat([depth] * 2)
            # the ground-truth latent only where the path reads it
            gt = (self.encode_imgs(rgb, d["eps_enc"])
                  if noised_gt_init or use_latent_blending else None)
            if noised_gt_init:
                latents = pndm.add_noise(gt, d["noise"], timesteps[0])
            else:
                latents = d["latents"]
            mask_small = resize_nearest(update_mask, (S, S))
            mask_lat = resize_nearest(update_mask, (lat_sz, lat_sz))
            masked_latents = None
            if use_inpaint and len(timesteps) > 11:  # some i in (10, 20)
                masked = rgb * (mask_small < 0.5) + 0.5 * (mask_small >= 0.5)
                masked_latents = self.encode_imgs(masked, d["eps_enc2"])
            text = text_embeddings.to(dev)
            state = pndm.init_state(latents.shape, dev)
            n_vis = min(10, len(timesteps))
            sel = set(np.linspace(0, len(timesteps) - 1, n_vis).astype(
                np.int32).tolist()) if intermediate_vis else set()
            inters = []
            for i, t in enumerate(timesteps):
                if use_latent_blending and (i <= 10 or i >= 20):
                    truth = pndm.add_noise(gt, d["noise"], t)
                    latents = latents * mask_lat + truth * (1 - mask_lat)
                if masked_latents is not None and 10 < i < 20:
                    unet = self.inpaint_unet
                    lat_in = torch.cat([torch.cat([latents] * 2),
                                        torch.cat([mask_lat] * 2),
                                        torch.cat([masked_latents] * 2)], 1)
                else:
                    unet = self.unet
                    lat_in = torch.cat([torch.cat([latents] * 2), depth_pair],
                                       1)
                noise_pred = self._cfg(unet, lat_in, t, text, guidance_scale)
                state, latents = pndm.step(state, noise_pred, t, latents,
                                           num_inference_steps)
                if i in sel:
                    inters.append(latents)
        with phase(timings, "bootstrap_decode", dev):
            img = self.decode_latents(latents)
            intermediates = [self.decode_latents(x) for x in inters]
        return img, intermediates

    # -- txt2img and SDS ---------------------------------------------------------

    def _cfg(self, unet: nn.Module, lat_in, t, text_embeddings,
             guidance_scale: float) -> torch.Tensor:
        """CFG over the [uncond; cond] batch: the difference in the tower
        dtype, the guidance in f32."""
        u, c = unet(lat_in, t, text_embeddings.to(self.device)).chunk(2)
        return u.float() + guidance_scale * (c - u).float()

    @staticmethod
    def _normalize_depth(depth: torch.Tensor) -> torch.Tensor:
        dmin, dmax = depth.min(), depth.max()
        return 2.0 * (depth - dmin) / torch.clamp(dmax - dmin, min=1e-8) - 1.0

    @torch.no_grad()
    def img2img_single_step(self, text_embeddings, prev_latents, depth_mask,
                            step: int, guidance_scale: float = 100.0,
                            num_inference_steps: int = 50) -> torch.Tensor:
        """One CFG denoise step at timestep `step` from a fresh PLMS state:
        the depth resized (bicubic) to the latent and normalized to
        [-1, 1]."""
        lat = prev_latents.to(self.device, torch.float32)
        lat_sz = lat.shape[-1]
        depth = self._normalize_depth(resize_bicubic(
            depth_mask.to(self.device, torch.float32), (lat_sz, lat_sz)))
        lat_in = torch.cat([torch.cat([lat] * 2), torch.cat([depth] * 2)], 1)
        noise_pred = self._cfg(self.unet, lat_in, [step], text_embeddings,
                               guidance_scale)
        state = self.scheduler.init_state(lat.shape, self.device)
        _, prev = self.scheduler.step(state, noise_pred, step, lat,
                                      num_inference_steps)
        return prev

    @torch.no_grad()
    def produce_latents(self, text_embeddings, depth_mask,
                        latents: Optional[torch.Tensor] = None,
                        height: int = 512, width: int = 512,
                        num_inference_steps: int = 50,
                        guidance_scale: float = 7.5,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """txt2img latents: the PLMS loop under CFG from `latents` (N, 4,
        h, w), N the text pairs (a normal draw from `generator`, seeded 0
        if None, when not given), the depth (N, 1, h, w) at the latent
        size beside them."""
        down = self.vae_config.downsample
        shape = (text_embeddings.shape[0] // 2,
                 self.unet_config.in_channels - 1, height // down,
                 width // down)
        if latents is None:
            g = generator or torch.Generator(device=self.device).manual_seed(0)
            latents = torch.randn(shape, generator=g, device=g.device)
        latents = latents.to(self.device, torch.float32)
        depth_pair = torch.cat([depth_mask.to(self.device,
                                              torch.float32)] * 2)
        pndm = self.scheduler
        state = pndm.init_state(latents.shape, self.device)
        for t in pndm.timesteps(num_inference_steps):
            lat_in = torch.cat([torch.cat([latents] * 2), depth_pair], 1)
            noise_pred = self._cfg(self.unet, lat_in, t, text_embeddings,
                                   guidance_scale)
            state, latents = pndm.step(state, noise_pred, t, latents,
                                       num_inference_steps)
        return latents

    @torch.no_grad()
    def prompt_to_img(self, prompts, depth_mask, height: int = 512,
                      width: int = 512, num_inference_steps: int = 50,
                      guidance_scale: float = 7.5, seed: int = 0,
                      latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """Text -> image by depth-conditioned txt2img: the depth (N,1,H,W)
        normalized to [-1, 1] and resized (bicubic) to the latent, the
        latents from a generator seeded `seed` (or `latents`), decoded.
        Returns (N, height, width, 3) uint8."""
        if isinstance(prompts, str):
            prompts = [prompts]
        text_embeds = self.get_text_embeds(prompts)
        down = self.vae_config.downsample
        depth = resize_bicubic(self._normalize_depth(
            depth_mask.to(self.device, torch.float32)),
            (height // down, width // down))
        latents = self.produce_latents(
            text_embeds, depth, latents=latents, height=height, width=width,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            generator=torch.Generator(device=self.device).manual_seed(seed))
        imgs = self.decode_latents(latents).float()
        return (imgs.permute(0, 2, 3, 1) * 255).round().to(
            torch.uint8).cpu().numpy()

    @torch.no_grad()
    def sds_grad(self, latents, text_embeddings, depth_mask,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 guidance_scale: float = 100.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The eps-prediction SDS gradient with respect to the latents,
        w(t) (eps_pred - eps) with w = 1 - alphas_cumprod[t], through
        nan_to_num. t ((1,), drawn uniformly from [min_step, max_step]
        when None) and the noise (a normal draw when None; zeros with
        no_noise) come from `generator` (seeded 0 if None) in that order.
        depth_mask is at the latent size, beside each latent."""
        g = generator or torch.Generator(device=self.device).manual_seed(0)
        if t is None:
            t = torch.randint(self.min_step, self.max_step + 1, (1,),
                              generator=g, device=g.device)
        t = torch.as_tensor(t, device=self.device).long().reshape(-1)
        latents = latents.to(self.device, torch.float32)
        if self.no_noise:
            noise = torch.zeros_like(latents)
        elif noise is None:
            noise = torch.randn(latents.shape, generator=g, device=g.device)
        noise = noise.to(self.device, torch.float32)
        noisy = sch.add_noise(self.alphas, latents, noise, t)
        depth = depth_mask.to(self.device, torch.float32)
        lat_in = torch.cat([torch.cat([noisy] * 2), torch.cat([depth] * 2)],
                           1)
        noise_pred = self._cfg(self.unet, lat_in, t, text_embeddings,
                               guidance_scale)
        w = (1 - self.alphas[t]).reshape(-1, 1, 1, 1)
        return torch.nan_to_num(w * (noise_pred - noise))
