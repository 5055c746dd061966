"""The plain reference of a Zero123++ ground-truth grid, in f32: the CLIP
text tower (OpenCLIP ViT-H's, SD2: 23 x 1024, 16 heads, causal) and vision
tower (ViT-H/14 at 224 px, 32 x 1280, projection 1024), the conditioning
(the VAE posterior samples of the condition image and of an all-zero
image; the empty prompt's hidden states, and those plus the ramped image
embedding), the EulerAncestral sampler (v-prediction, trailing spacing)
over the teacher's CFG call, and the VAE decode of the final latent.
Names follow the measured program's modules, so one weight dictionary
loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.layers import Conv, Dense, LayerNormF32
from portbench.reference.sds import (cfg_v_pred, hint_embedding,
                                     resize_linear, unscale_image,
                                     unscale_latents)
from portbench.reference.towers import encode_moments

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPTextConfig:
    def __init__(self, vocab_size=49408, hidden_size=1024, num_layers=23,
                 num_heads=16, intermediate_size=4096, max_positions=77):
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.num_layers, self.num_heads = num_layers, num_heads
        self.intermediate_size, self.max_positions = \
            intermediate_size, max_positions

    @staticmethod
    def tiny():
        return CLIPTextConfig(1000, 32, 2, 2, 64)


class CLIPVisionConfig:
    def __init__(self, hidden_size=1280, num_layers=32, num_heads=16,
                 intermediate_size=5120, image_size=224, patch_size=14,
                 projection_dim=1024):
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.num_heads, self.intermediate_size = num_heads, intermediate_size
        self.image_size, self.patch_size = image_size, patch_size
        self.projection_dim = projection_dim

    @staticmethod
    def tiny():
        return CLIPVisionConfig(32, 2, 2, 64, 32, 8, 32)


class CLIPLayer(nn.Module):
    def __init__(self, hidden, heads, intermediate, causal):
        super().__init__()
        self.hidden, self.heads, self.causal = hidden, heads, causal
        self.layer_norm1 = LayerNormF32(hidden)
        self.q_proj = Dense(hidden, hidden)
        self.k_proj = Dense(hidden, hidden)
        self.v_proj = Dense(hidden, hidden)
        self.out_proj = Dense(hidden, hidden)
        self.layer_norm2 = LayerNormF32(hidden)
        self.fc1 = Dense(hidden, intermediate)
        self.fc2 = Dense(intermediate, hidden)

    def forward(self, x):
        h = self.layer_norm1(x)
        B, S, _ = h.shape
        hd = self.hidden // self.heads

        def split(t):
            return t.reshape(B, S, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(h)), split(self.k_proj(h)), \
            split(self.v_proj(h))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if self.causal:
            mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, -1e30)
        o = torch.matmul(torch.softmax(logits, dim=-1), v)
        x = x + self.out_proj(o.transpose(1, 2).reshape(B, S, self.hidden))
        return x + self.fc2(F.gelu(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden_size))
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, True))
        self.final_layer_norm = LayerNormF32(cfg.hidden_size)

    def forward(self, ids):
        x = self.token_embedding(ids) + self.position_embedding[None,
                                                                :ids.shape[1]]
        for i in range(self.config.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.final_layer_norm(x)

    def empty_prompt_ids(self, device):
        """The CLIP tokenizer's empty prompt: bos, then eos to the end."""
        v, n = self.config.vocab_size, self.config.max_positions
        ids = torch.full((1, n), v - 1, dtype=torch.long, device=device)
        ids[0, 0] = v - 2
        return ids


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        p = cfg.patch_size
        n_tokens = (cfg.image_size // p) ** 2 + 1
        self.patch_embedding = Conv(3, cfg.hidden_size, p, stride=p,
                                    bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(n_tokens, cfg.hidden_size))
        self.pre_layrnorm = LayerNormF32(cfg.hidden_size)
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, False))
        self.post_layernorm = LayerNormF32(cfg.hidden_size)
        self.visual_projection = Dense(cfg.hidden_size, cfg.projection_dim,
                                       bias=False)

    def forward(self, pixels):
        x = self.patch_embedding(pixels)
        B, C = x.shape[:2]
        h = torch.cat([self.class_embedding.expand(B, 1, C),
                       x.flatten(2).transpose(1, 2)], dim=1)
        h = self.pre_layrnorm(h + self.position_embedding[None])
        for i in range(self.config.num_layers):
            h = getattr(self, f"layers_{i}")(h)
        return self.visual_projection(self.post_layernorm(h[:, 0]))


def trailing_timesteps(n_train: int, n: int) -> List[int]:
    """diffusers' "trailing" spacing, descending: round(arange(T, 0, -T/n))
    - 1, the arange in f32, rounding half to even."""
    ts = np.arange(n_train, 0, -n_train / n, dtype=np.float32)
    return (np.round(ts).astype(np.int64) - 1).tolist()


def conditioning(towers: Dict[str, nn.Module], cond_image, eps_cond, eps_neg,
                 ramping):
    """cond_image (1,3,H,W) in [-1,1] -> (cond_lat_pair [negative, positive]
    (unscaled posterior samples), encoder hidden states [empty, empty +
    ramped image embedding])."""
    enc = towers["vae_encoder"]

    def sample(img, eps):
        mean, logvar = encode_moments(enc, img)
        return mean + torch.exp(0.5 * logvar) * eps

    cond_lat = sample(cond_image, eps_cond)
    neg_lat = sample(torch.zeros_like(cond_image), eps_neg)
    vision = towers["vision_encoder"]
    sz = vision.config.image_size
    x01 = resize_linear(cond_image / 2 + 0.5, (sz, sz))
    dev = cond_image.device
    mean = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=dev).reshape(1, 3, 1, 1)
    global_embeds = vision((x01 - mean) / std)[:, None, :]
    text = towers["text_encoder"]
    text_embeds = text(text.empty_prompt_ids(dev))
    cond_hidden = text_embeds + global_embeds * ramping.reshape(1, -1, 1)
    return (torch.cat([neg_lat, cond_lat]),
            torch.cat([text_embeds, cond_hidden]))


def sigmas_for(acp, steps: int):
    """The trailing timesteps and their sigmas, with a final 0."""
    ts = trailing_timesteps(acp.shape[0], steps)
    all_sigmas = torch.sqrt((1 - acp) / acp)
    return ts, torch.cat([all_sigmas[torch.tensor(ts, device=acp.device)],
                          all_sigmas.new_zeros(1)])


def teacher_v(towers, acp, lat, t, sigma, cond_lat_pair, ehs, emb, write_neg,
              write_cond, guidance_scale):
    """The CFG v-prediction of one denoising step at latent `lat`."""
    return cfg_v_pred(towers["unet"], towers["controlnet"], acp, lat, t,
                      cond_lat_pair, ehs, emb, write_neg, write_cond,
                      guidance_scale,
                      scale_input=lambda x: x / torch.sqrt(sigma ** 2 + 1))


def euler_step(lat, v, sigma, sigma_to, noise):
    """One EulerAncestral step (v-prediction) from sigma to sigma_to."""
    x0 = v * (-sigma / torch.sqrt(sigma ** 2 + 1)) + lat / (sigma ** 2 + 1)
    sigma_up = torch.sqrt(sigma_to ** 2 * (sigma ** 2 - sigma_to ** 2)
                          / sigma ** 2)
    sigma_down = torch.sqrt(sigma_to ** 2 - sigma_up ** 2)
    return lat + (lat - x0) / sigma * (sigma_down - sigma) + noise * sigma_up


def decode(towers, lat, vae_config):
    """Scaled latents -> the [0, 1] RGB grid."""
    img = towers["vae_decoder"](unscale_latents(lat) / vae_config.scaling_factor)
    return torch.clamp(unscale_image(img) / 2 + 0.5, 0.0, 1.0)


def generate(towers: Dict[str, nn.Module], acp, cond_image, depth_image,
             draws: Dict[str, torch.Tensor], ramping, steps: int,
             guidance_scale: float, vae_config) -> torch.Tensor:
    """The EulerAncestral grid from the given draws; returns the [0, 1] RGB
    grid (1, 3, H, W)."""
    cond_lat_pair, ehs = conditioning(towers, cond_image, draws["eps_cond"],
                                      draws["eps_neg"], ramping)
    lat = draws["latents"]
    emb = hint_embedding(towers["controlnet"], depth_image,
                         (lat.shape[2], lat.shape[3]))
    ts, sigmas = sigmas_for(acp, steps)
    lat = lat * sigmas[0]
    for i, t in enumerate(ts):
        v = teacher_v(towers, acp, lat, t, sigmas[i], cond_lat_pair, ehs, emb,
                      draws["write_neg"][i], draws["write_cond"][i],
                      guidance_scale)
        lat = euler_step(lat, v, sigmas[i], sigmas[i + 1], draws["step"][i])
    return decode(towers, lat, vae_config)
