"""The Zero123++ teacher and generator: UNet with reference attention +
depth ControlNet + the VAE + the CLIP text and vision towers, the
latent/image scalings, and the EulerAncestral generation loop.

Counterpart of contexture_nerf_tpu/diffusion/zero123plus.py
(`scale_latents` ... `unscale_image`, `default_ramping_coefficients`, and
`Zero123PlusPipeline`). `Zero123PlusTeacher` holds what the SDS step needs
(`encode_condition_image`, `prepare_conditioning`, `embed_control_cond`,
`_cfg_core`, `_cfg_v_pred`, `_cfg_v_pred_individual` and the single-step
`teacher_v_pred`); its subclass
`Zero123PlusPipeline` adds the VAE decoder, the samplers,
`attach_inpaint_unet` and `generate`. The conditioning and the loop take
their normal draws as tensors, so a test can feed the reference's. Towers
with a local diffusers checkpoint (`Zero123PlusWeightPaths`) load it
through diffusion/weights.py, and the ramping coefficients come from the
snapshot's model_index.json.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch import phase, resolve_device
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion import weights as W
from contexture_nerf_tpu_torch.diffusion.clip import (
    CLIPTextConfig, CLIPTextModel, CLIPTokenizer, CLIPVisionConfig,
    CLIPVisionModelWithProjection)
from contexture_nerf_tpu_torch.diffusion.controlnet import (ControlNet,
                                                            embed_cond)
from contexture_nerf_tpu_torch.diffusion.layers import set_quant
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Decoder, Encoder,
                                                     VAEConfig, decode,
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
    the 3x2 grid's tiles. `set_int8` (optim.int8_controlnet /
    int8_teacher) quantizes the ControlNet, or the UNet and the
    ControlNet, to W8A8 on the fly; the weights and the state_dicts stay
    as they are."""

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
        self.set_int8()

    def set_int8(self, int8_controlnet: bool = False,
                 int8_unet: bool = False) -> None:
        """W8A8 teacher towers: int8_unet quantizes the UNet and the
        ControlNet, int8_controlnet the ControlNet alone (the reference's
        quant flags of each tower)."""
        self.int8_controlnet = bool(int8_controlnet)
        self.int8_unet = bool(int8_unet)
        set_quant(self.unet, self.int8_unet)
        set_quant(self.controlnet, self.int8_controlnet or self.int8_unet)

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
                  depth_image, neg_noise, cond_noise, cn_cond_emb=None,
                  scale_input: Optional[Callable] = None
                  ) -> List[torch.Tensor]:
        """Reference-attention UNet + depth ControlNet over nb CFG branches;
        per-branch v-predictions (B,4,H,W). Write-pass noise: `neg_noise`
        for the negative branch (row 0), `cond_noise` shared by the rest;
        the cond latent is DDPM-noised to t and fed as it is.
        `scale_input` scales the denoised branches' input (EulerAncestral's
        scale_model_input); None, the DDPM teacher's, scales nothing."""
        B = latents.shape[0]
        nb = branch_cond_lats.shape[0]
        branch_noise = torch.stack([neg_noise] + [cond_noise] * (nb - 1)).to(
            branch_cond_lats.dtype)
        cond_lats = branch_cond_lats.repeat_interleave(B, dim=0)
        ehs = branch_ehs.repeat_interleave(B, dim=0)
        noise = branch_noise.repeat_interleave(B, dim=0)
        lat_in = torch.cat([latents] * nb)
        if scale_input is not None:
            lat_in = scale_input(lat_in)

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
                    cn_cond_emb=None, scale_input: Optional[Callable] = None):
        """Two-branch CFG: v_u + g (v_c - v_u), in the towers' dtype."""
        v_uncond, v_cond = self._cfg_core(
            latents, t, cond_lat_pair, encoder_hidden_states, depth_image,
            neg_noise, cond_noise, cn_cond_emb, scale_input)
        return v_uncond + guidance_scale * (v_cond - v_uncond)

    def teacher_v_pred(self, latents_noisy, t, cond_lat_pair,
                       encoder_hidden_states, depth_image,
                       guidance_scale: float,
                       neg_noise: Optional[torch.Tensor] = None,
                       cond_noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       cn_cond_emb=None) -> torch.Tensor:
        """The single-step SDS teacher: the two-branch CFG v-prediction at
        externally noised latents, with DDPM's identity input scale. The
        write pass's noises (each cond_lat_pair.shape[1:]) are `neg_noise`
        and `cond_noise`, or, when not given, two normal draws from
        `generator` in that order (as SDSTrainer.draw takes them). The SDS
        step's own teacher call is this one."""
        if neg_noise is None or cond_noise is None:
            if generator is None:
                raise ValueError("teacher_v_pred needs neg_noise and "
                                 "cond_noise, or a generator")
            shape = tuple(cond_lat_pair.shape[1:])
            neg_noise, cond_noise = (
                torch.randn(shape, generator=generator,
                            device=generator.device).to(cond_lat_pair.device)
                for _ in range(2))
        return self._cfg_v_pred(latents_noisy, t, cond_lat_pair,
                                encoder_hidden_states, depth_image,
                                guidance_scale, neg_noise, cond_noise,
                                cn_cond_emb, scale_input=None)

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


GENERATION_STEP_DRAWS = ("write_neg", "write_cond", "step", "blend")


class Zero123PlusPipeline(Zero123PlusTeacher):
    """The teacher plus what generation needs: the VAE decoder (random from
    `generator` after the teacher's towers, or loaded from the same
    weight_paths.vae as the encoder), EulerAncestral (v_prediction,
    trailing) and DDPM (v_prediction) over the teacher's schedule, and an
    optional SD2-inpaint UNet (`attach_inpaint_unet`), which stays exact
    under set_int8, as the reference's."""

    def __init__(self, tiny: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weight_paths: Optional[Zero123PlusWeightPaths] = None):
        super().__init__(tiny, device, generator, weight_paths)
        wp = weight_paths or Zero123PlusWeightPaths()
        with torch.device(self.alphas_cumprod.device):
            self.vae_decoder = Decoder(self.vae_config, self.dtype)
        if generator is not None:
            random_init_(self.vae_decoder, generator)
        self.vae_decoder.to(self.dtype).requires_grad_(False)
        self.loaded.update(W.load_towers_([
            ("vae_decoder", self.vae_decoder, wp.vae, W.convert_vae,
             self.vae_config, "decoder")]))
        self.euler = sch.EulerAncestral(self.alphas_cumprod,
                                        prediction_type="v_prediction",
                                        timestep_spacing="trailing")
        self.ddpm = sch.DDPM(self.alphas_cumprod,
                             prediction_type="v_prediction")
        # held outside the module tree: the SD2 stack owns it
        self._attached: Dict[str, nn.Module] = {}

    @property
    def inpaint_unet(self) -> Optional[nn.Module]:
        return self._attached.get("inpaint_unet")

    def attach_inpaint_unet(self, module: nn.Module) -> None:
        """Wire the SD2-stack's 9-channel inpaint UNet
        (`StableDiffusionDepth.inpaint_unet`) into `generate`."""
        self._attached["inpaint_unet"] = module

    def draw_generation(self, cond_hw, num_inference_steps: int,
                        height: int, width: int,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """generate's normal draws from `generator`, every one whatever the
        flags (so variants share their streams): eps_cond and eps_neg (the
        conditioning's posterior samples), latents, and stacked over the
        steps write_neg and write_cond (_cfg_core's write-pass noises), step
        (the Euler noise) and blend."""
        down, c = self.vae_config.downsample, self.vae_config.latent_channels
        dev = generator.device
        cond = (c, cond_hw[0] // down, cond_hw[1] // down)
        lat = (c, height // down, width // down)
        n = num_inference_steps

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        d = {"eps_cond": normal(1, *cond), "eps_neg": normal(1, *cond),
             "latents": normal(1, *lat)}
        steps = [[normal(*cond), normal(*cond), normal(1, *lat),
                  normal(1, *lat)] for _ in range(n)]
        for k, name in enumerate(GENERATION_STEP_DRAWS):
            d[name] = torch.stack([s[k] for s in steps])
        return d

    @torch.no_grad()
    def decode_grid(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (1,4,h,w) -> the [0,1] RGB grid, f32."""
        img = decode(self.vae_decoder, unscale_latents(latents)
                     / self.vae_config.scaling_factor).float()
        return torch.clamp(unscale_image(img) / 2 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def generate(self, cond_image: torch.Tensor, depth_image: torch.Tensor,
                 num_inference_steps: int = 28, guidance_scale: float = 4.0,
                 height: int = 960, width: int = 640,
                 use_blending: bool = False, use_inpaint: bool = False,
                 latent_mask_grid: Optional[torch.Tensor] = None,
                 latent_renders_grid: Optional[torch.Tensor] = None,
                 masked_input_latents: Optional[torch.Tensor] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[Dict[str, float]] = None
                 ) -> torch.Tensor:
        """EulerAncestral generation of the 3x2 grid. cond_image (1,3,Hc,Wc)
        in [-1,1]; depth_image (1,3,height,width) in [0,1]. Returns the
        [0,1] RGB grid (1,3,height,width), f32.

        use_blending: before each step outside the inpaint range the latent
        becomes lat*mask + (renders + sigma_i eps)*(1 - mask), and after
        the last it is blended with the clean renders (the reference noises
        the renders grid, not the mask grid). use_inpaint: the steps
        10 < i < 20 run the attached 9-channel UNet on the whole
        [lat, mask, masked latents] concat scaled by scale_model_input,
        under CFG with the difference in the tower dtype and the guidance
        in f32; its output feeds the same v-prediction Euler step.
        latent_mask_grid (1,1,h,w), 1 = generate; latent_renders_grid and
        masked_input_latents (1,4,h,w) in the scale_latents domain. `draws`
        (draw_generation's) default to `generator` (seeded 0 if None).
        `timings` receives generate_conditioning, generate_steps and
        generate_decode."""
        if use_inpaint and self.inpaint_unet is None:
            raise ValueError("use_inpaint=True requires attach_inpaint_unet")
        if (use_blending or use_inpaint) and latent_mask_grid is None:
            raise ValueError("use_blending/use_inpaint require "
                             "latent_mask_grid")
        if use_blending and latent_renders_grid is None:
            raise ValueError("use_blending requires latent_renders_grid")
        if use_inpaint and masked_input_latents is None:
            raise ValueError("use_inpaint requires masked_input_latents")
        dev, f32 = self.alphas_cumprod.device, torch.float32
        euler = self.euler
        ts, sigmas = euler.timesteps_and_sigmas(num_inference_steps)
        down = self.vae_config.downsample
        h, w = height // down, width // down
        if draws is None:
            draws = self.draw_generation(
                cond_image.shape[2:], len(ts), height, width,
                generator or torch.Generator(device=dev).manual_seed(0))
        d = {k: v.to(dev) for k, v in draws.items()}

        def lat_input(x):
            return None if x is None else x.to(dev, f32)

        mask = lat_input(latent_mask_grid)
        renders = lat_input(latent_renders_grid)
        masked = lat_input(masked_input_latents)
        with phase(timings, "generate_conditioning", dev):
            cond_lat_pair, ehs = self.prepare_conditioning(
                cond_image.to(dev, f32), d["eps_cond"], d["eps_neg"])
            depth = depth_image.to(dev, f32)
            cn_emb = self.embed_control_cond(depth, (h, w))
        with phase(timings, "generate_steps", dev):
            lat = d["latents"].to(f32) * sigmas[0]
            for i, t in enumerate(ts):
                sigma = sigmas[i]
                in_inpaint = use_inpaint and 10 < i < 20
                if use_blending and not in_inpaint:
                    lat = lat * mask + euler.add_noise(
                        renders, d["blend"][i].to(f32), sigma) * (1 - mask)
                if in_inpaint:
                    nine = torch.cat([lat, mask, masked], dim=1)
                    nine = euler.scale_model_input(torch.cat([nine] * 2),
                                                   sigma)
                    u, c = self.inpaint_unet(nine, t, ehs).chunk(2)
                    v = u.float() + guidance_scale * (c - u).float()
                else:
                    v = self._cfg_v_pred(
                        lat, t, cond_lat_pair, ehs, depth, guidance_scale,
                        d["write_neg"][i], d["write_cond"][i],
                        cn_cond_emb=cn_emb,
                        scale_input=lambda x: euler.scale_model_input(
                            x, sigma))
                lat = euler.step(v, i, lat, sigmas, d["step"][i].to(f32))
            if use_blending:
                lat = lat * mask + renders * (1 - mask)
        with phase(timings, "generate_decode", dev):
            return self.decode_grid(lat)
