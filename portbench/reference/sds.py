"""The plain reference of one SDS step of the texture loop, in f32.

It follows the step as the configuration states it: the NeRF2D texture
field (8x256 ReLU MLP over the 42-wide Fourier embedding of the UVs, skip
after layer 4; the ConTEXTure-NeRF `run_nerf_helpers.py`) queried at the
grid's UVs, or over the whole texture lattice sampled at the 6 views' cached
UVs (`exact`); the composite on grey; the VAE encode and its posterior
sample; DDPM noising; the Zero123++ teacher (a write pass of the UNet over
the noised condition latents, the depth ControlNet, a read pass attending
to the write pass's tokens) under two-branch CFG; the v-target, the SDS
target and the 1/2-sum-square loss on the sampled tile; the backward to the
MLP (through a margin-padded slice around the tile with `local_grad`, over
the whole canvas otherwise) and an Adam step. It derives everything from
the inputs it is given: the Fourier embedding, the ControlNet's hint
embedding and the texture map.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.towers import encode_moments

GUIDANCE_SCALE = 10.0
GRAD_SCALE = 0.2
CONDITIONING_SCALE = 2.0
MULTIRES = 10


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the texture field -----------------------------------------------------------

def fourier_embed(x: torch.Tensor, multires: int = MULTIRES) -> torch.Tensor:
    outs = [x]
    for i in range(multires):
        f = float(2.0 ** i)
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


class NeRF2D(nn.Module):
    D, W, SKIP, INPUT_CH, OUTPUT_CH = 8, 256, 4, 42, 3

    def __init__(self):
        super().__init__()
        fan_in = self.INPUT_CH
        for i in range(self.D):
            setattr(self, f"pts_linear_{i}", nn.Linear(fan_in, self.W))
            fan_in = self.W + (self.INPUT_CH if i == self.SKIP else 0)
        self.output_linear = nn.Linear(fan_in, self.OUTPUT_CH)

    def forward(self, uv: torch.Tensor) -> torch.Tensor:
        inp = fourier_embed(uv)
        h = inp
        for i in range(self.D):
            h = torch.relu(getattr(self, f"pts_linear_{i}")(h))
            if i == self.SKIP:
                h = torch.cat([inp, h], dim=-1)
        return self.output_linear(h)


def colors(mlp: NeRF2D, uv: torch.Tensor) -> torch.Tensor:
    return (torch.tanh(mlp(uv)) + 1.0) / 2.0


def uv_lattice(res: int, device) -> torch.Tensor:
    """pixel (row i, col j) -> (u = j / (res - 1), v = i / (res - 1))."""
    lin = torch.linspace(0.0, 1.0, res, device=device)
    vv, uu = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([uu, vv], dim=-1).reshape(-1, 2)


# -- schedules and scalings ------------------------------------------------------------

def alphas_cumprod(device) -> torch.Tensor:
    """SD's scaled-linear schedule, 1000 steps, b0 = 0.00085, b1 = 0.012."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def dreamtime_schedule(acp: torch.Tensor, total_iterations: int,
                       m: float = 500, s: float = 125) -> List[int]:
    """DreamTime's t(i) for i in [0, N)."""
    acp = acp.float().cpu()
    T = acp.shape[0]
    ts = torch.arange(T, dtype=torch.float32)
    w = torch.sqrt(1 - acp) * torch.exp(-((ts - m) ** 2) / (2 * s ** 2))
    w = w / w.sum()
    survival = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    targets = torch.arange(total_iterations,
                           dtype=torch.float32) / total_iterations
    return torch.argmin(torch.abs(survival[None, :] - targets[:, None]),
                        dim=1).tolist()


def add_noise(acp, sample, noise, t):
    a = acp[t].reshape(-1, *([1] * (sample.dim() - 1)))
    return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise


def velocity_target(acp, sample, noise, t):
    a = acp[t].reshape(-1, *([1] * (sample.dim() - 1)))
    return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample


def scale_latents(latents):
    return (latents - 0.22) * 0.75


def unscale_latents(latents):
    return latents / 0.75 + 0.22


def scale_image(image):
    return image * 0.5 / 0.8


def unscale_image(image):
    return image / 0.5 * 0.8


# -- image and grid operations -------------------------------------------------------

def resize_linear(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear resize, antialiased when it shrinks, in f32."""
    return F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def crop_and_resize(x, bbox, out_h: int, out_w: int):
    min_h, min_w, max_h, max_w = bbox
    return resize_linear(x[:, :, min_h:max_h, min_w:max_w], (out_h, out_w))


def merge_6_to_grid(tiles: torch.Tensor) -> torch.Tensor:
    """(6, C, t, t) -> (1, C, 3t, 2t); column 0 holds views 0, 1, 2."""
    n, C, t, _ = tiles.shape
    x = tiles.reshape(2, 3, C, t, t).permute(2, 1, 3, 0, 4)
    return x.reshape(1, C, 3 * t, 2 * t)


def split_grid_to_6(grid: torch.Tensor, t: int) -> torch.Tensor:
    _, C, H, W = grid.shape
    x = grid.reshape(C, 3, t, 2, t).permute(3, 1, 0, 2, 4)
    return x.reshape(6, C, t, t)


def sample_texture(uv: torch.Tensor, texture: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of texture (1, C, TH, TW) at uv (B, H, W, 2) in
    [0, 1], v flipped, zero outside (grid_sample, align_corners=False).
    Returns (B, H, W, C)."""
    B = uv.shape[0]
    _, C, TH, TW = texture.shape
    px = uv[..., 0] * TW - 0.5
    py = (1.0 - uv[..., 1]) * TH - 0.5
    flat = texture.reshape(1, C, TH * TW).expand(B, C, TH * TW)

    def gather(iy, ix):
        lin = (iy.clamp(0, TH - 1) * TW + ix.clamp(0, TW - 1)).reshape(B, 1, -1)
        out = torch.gather(flat, 2, lin.expand(B, C, lin.shape[-1]))
        out = out.permute(0, 2, 1).reshape(*iy.shape, C)
        inb = ((iy >= 0) & (iy < TH) & (ix >= 0) & (ix < TW))[..., None]
        return out * inb

    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


# -- the teacher -------------------------------------------------------------------------

def hint_embedding(controlnet, depth_image, latent_hw):
    th, tw = latent_hw[0] * 8, latent_hw[1] * 8
    if tuple(depth_image.shape[2:]) != (th, tw):
        depth_image = resize_linear(depth_image, (th, tw))
    return controlnet.controlnet_cond_embedding(depth_image)


def cfg_branches(unet, controlnet, acp, latents, t, cond_lat_pair, ehs,
                 cn_cond_emb, neg_noise, cond_noise, scale_input=None):
    """The two CFG branches' v-predictions [uncond, cond]: the write pass
    over the DDPM-noised condition latents, the ControlNet and the read
    pass."""
    noise = torch.stack([neg_noise, cond_noise])
    lat_in = torch.cat([latents] * 2)
    if scale_input is not None:
        lat_in = scale_input(lat_in)
    tt = torch.as_tensor(t, device=latents.device).reshape(-1)
    noisy_cond = add_noise(acp, cond_lat_pair, noise, tt.expand(2))
    ref: list = []
    unet(noisy_cond, tt, ehs, ref_out=ref)
    downs, mid = controlnet(lat_in, tt, ehs, torch.cat([cn_cond_emb] * 2),
                            CONDITIONING_SCALE)
    v = unet(lat_in, tt, ehs, down_residuals=downs, mid_residual=mid,
             ref_kv_list=ref)
    return v.chunk(2, dim=0)


def cfg_v_pred(unet, controlnet, acp, latents, t, cond_lat_pair, ehs,
               cn_cond_emb, neg_noise, cond_noise, guidance_scale,
               scale_input=None):
    v_u, v_c = cfg_branches(unet, controlnet, acp, latents, t, cond_lat_pair,
                            ehs, cn_cond_emb, neg_noise, cond_noise,
                            scale_input)
    return v_u + guidance_scale * (v_c - v_u)


# -- the SDS step ------------------------------------------------------------------------

class SDSReference:
    """The reference trainer. `towers` = (unet, controlnet, vae_encoder) in
    f32; `mlp` a NeRF2D in f32; `inputs` the benchmark's set-up inputs
    (depth_grid, mask_grid, uv_pts, cond_lat_pair, ehs; cache6 fields
    uv_features, mask and bboxes6 for exact); `optim` (lr, betas, eps)."""

    def __init__(self, towers, mlp: NeRF2D, inputs: Dict, tile_px: int,
                 vae_config, exact: bool, local_grad: bool, margin_px: int,
                 texture_res: int, optim: Tuple[float, Sequence[float], float]):
        self.unet, self.controlnet, self.vae = towers
        self.mlp = mlp
        self.inp = inputs
        self.tile_px = tile_px
        self.vae_config = vae_config
        self.vae_down = vae_config.downsample
        self.lat_tile = tile_px // self.vae_down
        self.grid_hw = (3 * tile_px, 2 * tile_px)
        self.exact = exact
        self.local_grad = local_grad and not exact
        self.sl_h = min(tile_px + 2 * margin_px, self.grid_hw[0])
        self.sl_w = min(tile_px + 2 * margin_px, self.grid_hw[1])
        self.texture_res = texture_res
        dev = inputs["depth_grid"].device
        self.acp = alphas_cumprod(dev)
        lat_hw = (self.grid_hw[0] // self.vae_down,
                  self.grid_hw[1] // self.vae_down)
        with torch.no_grad():
            self.cn_cond_emb = hint_embedding(self.controlnet,
                                              inputs["depth_grid"], lat_hw)
        lr, betas, eps = optim
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=lr,
                                          betas=tuple(betas), eps=eps)

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
        img = torch.clamp(img * mask + 0.5 * (1 - mask), 0.0, 1.0)
        return scale_image(img * 2 - 1)

    def _encode(self, img, eps):
        mean, logvar = encode_moments(self.vae, img)
        z = (mean + torch.exp(0.5 * logvar) * eps) * \
            self.vae_config.scaling_factor
        return scale_latents(z)

    def render_grid_latent(self, eps):
        if not self.exact:
            rgb = self._query()
            grid = self._composite(rgb, *self.grid_hw, self.inp["mask_grid"])
            return self._encode(grid, eps), grid
        res = self.texture_res
        uv = uv_lattice(res, eps.device)
        tex = colors(self.mlp, uv).reshape(1, res, res, 3).permute(0, 3, 1, 2)
        mask = self.inp["cache_mask"]
        image = sample_texture(self.inp["cache_uv"], tex).permute(0, 3, 1, 2)
        image = image * mask
        image = torch.clamp(image * mask + 0.5 * (1 - mask), 0.0, 1.0)
        tiles = [crop_and_resize(image[i:i + 1], b, self.tile_px,
                                 self.tile_px)
                 for i, b in enumerate(self.inp["bboxes6"])]
        grid = scale_image(merge_6_to_grid(torch.cat(tiles)) * 2 - 1)
        return self._encode(grid, eps), grid

    def slice_origin(self, tile_idx: int):
        tp, vd = self.tile_px, self.vae_down
        H, W = self.grid_hw
        row, col = tile_idx % 3, tile_idx // 3
        oy = min(max(row * tp - (self.sl_h - tp) // 2, 0), H - self.sl_h)
        ox = min(max(col * tp - (self.sl_w - tp) // 2, 0), W - self.sl_w)
        return (oy // vd) * vd, (ox // vd) * vd

    def render_grid_latent_local(self, eps, tile_idx: int):
        with torch.no_grad():
            z_full, _ = self.render_grid_latent(eps)
        tp, vd, lt = self.tile_px, self.vae_down, self.lat_tile
        sl_h, sl_w = self.sl_h, self.sl_w
        row, col = tile_idx % 3, tile_idx // 3
        oy, ox = self.slice_origin(tile_idx)
        rgb = self._query((oy, ox, sl_h, sl_w))
        mask = self.inp["mask_grid"][:, :, oy:oy + sl_h, ox:ox + sl_w]
        patch = self._composite(rgb, sl_h, sl_w, mask)
        eps_l = eps[:, :, oy // vd:(oy + sl_h) // vd,
                    ox // vd:(ox + sl_w) // vd]
        z_l = self._encode(patch, eps_l)
        ty, tx = (row * tp - oy) // vd, (col * tp - ox) // vd
        z_l_tile = z_l[:, :, ty:ty + lt, tx:tx + lt]
        zy, zx = row * lt, col * lt
        z = z_full.clone()
        z[:, :, zy:zy + lt, zx:zx + lt] = \
            z_full[:, :, zy:zy + lt, zx:zx + lt] + (z_l_tile - z_l_tile.detach())
        return z

    def step(self, t: int, d: Dict) -> Dict:
        """One step on the draws d (tile_idx, eps, noise, neg_noise,
        cond_noise); returns the loss, the gradient of each leaf and the
        whole canvas's Fisher divergence sum((sqrt(a) / sqrt(1 - a))^2
        (v_pred - v)^2), as the program's step does."""
        tile_idx = int(d["tile_idx"])
        eps = d["eps"].float()
        noise = d["noise"].float()
        tt = torch.tensor([int(t)], device=eps.device)
        self.optimizer.zero_grad(set_to_none=True)
        if self.local_grad:
            z = self.render_grid_latent_local(eps, tile_idx)
        else:
            z, _ = self.render_grid_latent(eps)
        z_sg = z.detach()
        with torch.no_grad():
            latents_noisy = add_noise(self.acp, z_sg, noise, tt)
            v_pred = cfg_v_pred(
                self.unet, self.controlnet, self.acp, latents_noisy, tt,
                self.inp["cond_lat_pair"], self.inp["ehs"], self.cn_cond_emb,
                d["neg_noise"].float(), d["cond_noise"].float(),
                GUIDANCE_SCALE)
        v = velocity_target(self.acp, z_sg, noise, tt)
        a = self.acp[tt].reshape(-1, 1, 1, 1)
        g = torch.nan_to_num(GRAD_SCALE * (1 - a) * torch.sqrt(a)
                             * (v_pred - v))
        targets = (z_sg - g).detach()
        zt = split_grid_to_6(z, self.lat_tile)[tile_idx]
        tt6 = split_grid_to_6(targets, self.lat_tile)[tile_idx]
        loss = 0.5 * torch.sum((zt - tt6) ** 2) / z.shape[0]
        loss.backward()
        grads = {k: p.grad.detach().clone()
                 for k, p in self.mlp.named_parameters()}
        self.optimizer.step()
        fisher = torch.sum((torch.sqrt(a) / torch.clamp(torch.sqrt(1 - a),
                                                        min=1e-8)) ** 2
                           * (v_pred - v) ** 2)
        return {"loss": float(loss.detach()), "grads": grads,
                "fisher": float(fisher)}
