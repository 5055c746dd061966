"""The SDS paint step and loop, counterparts of
contexture_nerf_tpu/training/trainer.py `_build_sds_step` (render_grid_latent,
render_grid_latent_local, sds_step) and the loop of `paint_zero123plus`.

`SDSTrainer` takes the `setup` dict that the reference's `prepare_sds`
returns (numpy arrays or tensors): depth_grid, mask_grid, uv_grid_pts,
cond_lat_pair, encoder_hidden_states and tile_probs. `prepare_sds` itself
(rasterizer, SD2-depth bootstrap, CLIP) and its `edit_mask_pts`
(guide.reference_texture) come with the next slices.

One step: query the texture MLP at the grid's UVs (the fused kernel on the
card), composite with the mask, VAE-encode and DDPM-noise, run the Zero123++
teacher (write pass, depth ControlNet, read pass, CFG), form the SDS target
and the 1/2-sum-square loss on one sampled latent tile, back-propagate
(through a margin-padded slice with local_sds_grad) and take an Adam step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.core.config import TrainConfig
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion.vae import encode_moments
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, scale_image, scale_latents)
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops.attention import routes_to_kernel
from contexture_nerf_tpu_torch.ops.grid import split_grid_to_6
from contexture_nerf_tpu_torch.ops.mlp_kernel import (fused_nerf2d,
                                                      fused_nerf2d_emb,
                                                      pad_embedding)

GUIDANCE_SCALE = 10.0  # reference trainer.py:768
GRAD_SCALE = 0.2  # reference trainer.py:830
MULTIRES = 10
LOG_EVERY = 50  # iterations between logged metrics, as the reference


def _to(x, device, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=device, dtype=dtype or t.dtype)


class SDSTrainer:
    """The SDS texture loop of the Zero123++ teacher on one device."""

    def __init__(self, cfg: TrainConfig, setup: Dict, teacher:
                 Optional[Zero123PlusTeacher] = None,
                 mlp: Optional[NeRF2D] = None, tiny: bool = False,
                 device="cuda"):
        dev = self.device = resolve_device(device)
        if cfg.optim.exact_lattice_render:
            raise NotImplementedError(
                "optim.exact_lattice_render renders through the raster "
                "cache of prepare_sds; it arrives with the rasterizer slice "
                "(raster/pallas_raster.py)")
        if setup.get("edit_mask_pts") is not None:
            raise NotImplementedError(
                "edit_mask_pts (guide.reference_texture) arrives with the "
                "prepare_sds slice")
        self.cfg = cfg
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.optim.seed)
        self.teacher = teacher or Zero123PlusTeacher(
            tiny=tiny, device=dev, generator=self.generator)
        self.dtype = self.teacher.dtype
        self.mlp = mlp or NeRF2D(generator=self.generator, device=dev)
        self.mlp.to(dev)
        self.tile_px = 32 if tiny else 320
        self.vae_down = self.teacher.vae_config.downsample
        self.lat_tile = self.tile_px // self.vae_down
        self.grid_hw = (3 * self.tile_px, 2 * self.tile_px)
        self.acp = self.teacher.alphas_cumprod
        opt = cfg.optim
        self.local_grad = bool(opt.local_sds_grad)
        margin = int(opt.local_sds_margin_px)
        if margin % self.vae_down:
            raise ValueError(
                f"optim.local_sds_margin_px={margin} must be a multiple of "
                f"the VAE downsample factor {self.vae_down}")
        self.sl_h = min(self.tile_px + 2 * margin, self.grid_hw[0])
        self.sl_w = min(self.tile_px + 2 * margin, self.grid_hw[1])
        g = cfg.guide
        self.individual = (g.individual_control_of_conditions
                           and g.guidance_scale_i is not None
                           and g.guidance_scale_t is not None)
        self.gs_i = float(g.guidance_scale_i or 0.0)
        self.gs_t = float(g.guidance_scale_t or 0.0)

        self.depth_grid = _to(setup["depth_grid"], dev, torch.float32)
        self.mask_grid = _to(setup["mask_grid"], dev, torch.float32)
        self.uv_pts = _to(setup["uv_grid_pts"], dev,
                          torch.float32).contiguous()
        self.cond_lat_pair = _to(setup["cond_lat_pair"], dev, self.dtype)
        self.ehs = _to(setup["encoder_hidden_states"], dev, self.dtype)
        self.tile_probs = _to(setup["tile_probs"], dev, torch.float32)
        self.emb_pts = (pad_embedding(self.uv_pts, MULTIRES, dtype=self.dtype)
                        if opt.precompute_uv_embedding else None)
        lat_hw = (self.depth_grid.shape[2] // self.vae_down,
                  self.depth_grid.shape[3] // self.vae_down)
        with torch.no_grad():
            # loop-invariant ControlNet hint embedding, hoisted
            self.cn_cond_emb = self.teacher.embed_control_cond(
                self.depth_grid, lat_hw)
        self.optimizer = torch.optim.Adam(
            self.mlp.parameters(), lr=opt.sds_lr,
            betas=tuple(opt.sds_betas), eps=opt.sds_eps)

    # -- student render ------------------------------------------------------

    def _query(self, window=None):
        """Texture colours in [0,1] at the grid's UVs, or at the window
        (oy, ox, h, w) of the grid, through the fused MLP."""
        H, W = self.grid_hw
        src = self.emb_pts if self.emb_pts is not None else self.uv_pts
        if window is not None:
            oy, ox, h, w = window
            src = src.reshape(H, W, -1)[oy:oy + h, ox:ox + w].reshape(
                h * w, -1).contiguous()
        fn = fused_nerf2d_emb if self.emb_pts is not None else fused_nerf2d
        out = fn(self.mlp, src, MULTIRES, compute_dtype=self.dtype)
        return (torch.tanh(out) + 1.0) / 2.0

    def _composite(self, rgb, h, w, mask):
        img = rgb.reshape(h, w, 3).permute(2, 0, 1)[None]
        img = torch.clamp(img * mask + 0.5 * (1 - mask), 0.0, 1.0)
        return scale_image(img * 2 - 1)

    def _encode(self, img, eps):
        mean, logvar = encode_moments(self.teacher.vae_encoder, img)
        z = (mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)) * \
            self.teacher.vae_config.scaling_factor
        return scale_latents(z)

    def render_grid_latent(self, eps):
        """Full canvas: MLP -> composite -> VAE encode. Returns (z, grid,
        rgb)."""
        rgb = self._query()
        grid = self._composite(rgb, *self.grid_hw, self.mask_grid)
        return self._encode(grid, eps), grid, rgb

    def slice_origin(self, tile_idx: int):
        """(oy, ox) of the backward slice around a tile (column-major tile
        order, latent-aligned)."""
        tp, vd = self.tile_px, self.vae_down
        H, W = self.grid_hw
        row, col = tile_idx % 3, tile_idx // 3
        oy = min(max(row * tp - (self.sl_h - tp) // 2, 0), H - self.sl_h)
        ox = min(max(col * tp - (self.sl_w - tp) // 2, 0), W - self.sl_w)
        return (oy // vd) * vd, (ox // vd) * vd

    def render_grid_latent_local(self, eps, tile_idx: int):
        """local_sds_grad: the full canvas runs forward only; the gradient
        flows through a (sl_h, sl_w) slice around the sampled tile, grafted
        into the tile of the full latent as a zero-valued delta."""
        with torch.no_grad():
            z_full, grid_full, rgb = self.render_grid_latent(eps)
        tp, vd, lt = self.tile_px, self.vae_down, self.lat_tile
        sl_h, sl_w = self.sl_h, self.sl_w
        row, col = tile_idx % 3, tile_idx // 3
        oy, ox = self.slice_origin(tile_idx)
        rgb_sl = self._query((oy, ox, sl_h, sl_w))
        mask_sl = self.mask_grid[:, :, oy:oy + sl_h, ox:ox + sl_w]
        patch = self._composite(rgb_sl, sl_h, sl_w, mask_sl)
        grid = grid_full.clone()
        grid[:, :, oy:oy + sl_h, ox:ox + sl_w] = patch.to(grid_full.dtype)
        g_sl = grid[:, :, oy:oy + sl_h, ox:ox + sl_w]
        eps_l = eps[:, :, oy // vd:(oy + sl_h) // vd,
                    ox // vd:(ox + sl_w) // vd]
        z_l = self._encode(g_sl, eps_l)
        ty, tx = (row * tp - oy) // vd, (col * tp - ox) // vd
        z_l_tile = z_l[:, :, ty:ty + lt, tx:tx + lt]
        zy, zx = row * lt, col * lt
        z = z_full.clone()
        z[:, :, zy:zy + lt, zx:zx + lt] = \
            z_full[:, :, zy:zy + lt, zx:zx + lt] + \
            (z_l_tile - z_l_tile.detach()).to(z_full.dtype)
        return z, grid, rgb

    # -- the step --------------------------------------------------------------

    def latent_shape(self):
        H, W = self.grid_hw
        return (1, 4, H // self.vae_down, W // self.vae_down)

    def draw(self) -> Dict[str, torch.Tensor]:
        """The step's random numbers from the trainer's generator."""
        g, dev = self.generator, self.device
        shape = self.latent_shape()
        cshape = tuple(self.cond_lat_pair.shape[1:])
        return {
            "tile_idx": torch.multinomial(self.tile_probs, 1, generator=g),
            "eps": torch.randn(shape, generator=g, device=dev).to(self.dtype),
            "noise": torch.randn(shape, generator=g, device=dev),
            "neg_noise": torch.randn(cshape, generator=g, device=dev),
            "cond_noise": torch.randn(cshape, generator=g, device=dev),
        }

    def step(self, t: int, draws: Optional[Dict] = None):
        """One SDS step at timestep t. `draws` (tile_idx, eps, noise,
        neg_noise, cond_noise) may be given, e.g. a reference's random
        numbers; otherwise they come from the trainer's generator. Returns
        (params, loss, grad_norm, fisher, grid) as the reference's sds_step
        does, params being the updated MLP state."""
        dev = self.device
        d = self.draw() if draws is None else draws
        tile_idx = int(d["tile_idx"])
        eps = _to(d["eps"], dev)
        noise = _to(d["noise"], dev, torch.float32)
        neg_noise = _to(d["neg_noise"], dev)
        cond_noise = _to(d["cond_noise"], dev)
        t_t = torch.tensor([int(t)], device=dev)

        self.optimizer.zero_grad(set_to_none=True)
        if self.local_grad:
            z, grid, _ = self.render_grid_latent_local(eps, tile_idx)
        else:
            z, grid, _ = self.render_grid_latent(eps)
        z_sg = z.detach()
        latents_noisy = sch.add_noise(self.acp, z_sg, noise, t_t)
        tch = self.teacher
        if self.individual:
            v_pred = tch._cfg_v_pred_individual(
                latents_noisy, t_t, self.cond_lat_pair, self.ehs,
                self.depth_grid, self.gs_i, self.gs_t, neg_noise, cond_noise,
                cn_cond_emb=self.cn_cond_emb)
        else:
            v_pred = tch._cfg_v_pred(
                latents_noisy, t_t, self.cond_lat_pair, self.ehs,
                self.depth_grid, GUIDANCE_SCALE, neg_noise, cond_noise,
                cn_cond_emb=self.cn_cond_emb)
        v = sch.velocity_target(self.acp, z_sg, noise, t_t)
        acp_t = self.acp[t_t].reshape(-1, 1, 1, 1)
        w = 1 - acp_t
        g = torch.nan_to_num(GRAD_SCALE * w * torch.sqrt(acp_t) * (v_pred - v))
        targets = (z_sg - g).detach()
        z_tiles = split_grid_to_6(z, self.lat_tile)
        tgt_tiles = split_grid_to_6(targets, self.lat_tile)
        loss = 0.5 * torch.sum(
            (z_tiles[tile_idx] - tgt_tiles[tile_idx]) ** 2) / z.shape[0]
        loss.backward()
        grads = [p.grad for p in self.mlp.parameters()]
        grad_norm = torch.sqrt(sum(torch.sum(gr.float() ** 2) for gr in grads))
        self.optimizer.step()
        fisher = torch.sum((torch.sqrt(acp_t) /
                            torch.clamp(torch.sqrt(1 - acp_t), min=1e-8)) ** 2
                           * torch.abs(v_pred - v) ** 2)
        params = {k: p.detach().clone()
                  for k, p in self.mlp.state_dict().items()}
        return params, loss.detach(), grad_norm.detach(), fisher, grid.detach()

    def t_schedule(self, iterations: int) -> torch.Tensor:
        return sch.dreamtime_schedule(self.acp, iterations, m=500, s=125)

    def paint(self, iterations: Optional[int] = None):
        """The SDS loop over the DreamTime t schedule; returns the metrics
        logged every LOG_EVERY iterations and at the last one."""
        n = self.cfg.optim.sds_iterations if iterations is None else iterations
        ts = self.t_schedule(n).tolist()
        metrics = []
        for i in range(n):
            _, loss, grad_norm, fisher, _ = self.step(ts[i])
            if i % LOG_EVERY == 0 or i == n - 1:
                metrics.append({"iter": i, "t": ts[i],
                                "sds_loss": float(loss),
                                "grad_norm": float(grad_norm),
                                "fisher_divergence_t": float(fisher)})
        return metrics

    # -- launches the step makes -------------------------------------------------

    def expected_kernel_launches(self) -> Dict[str, int]:
        """Kernel launches of one step on the card, derived from the
        configs and the attention routing rule: the MLP forward once for the
        canvas (plus once for the backward slice with local_sds_grad), its
        backward once, and every teacher self-attention the rule routes to
        the flash kernel (cross-attention's 77 tokens never are)."""
        ucfg = self.teacher.unet_config
        nb = len(ucfg.block_out_channels)
        lpb, depth = ucfg.layers_per_block, ucfg.transformer_depth

        def tokens(hw, level):
            h, w = hw
            for _ in range(level):
                h, w = -(-h // 2), -(-w // 2)
            return h * w

        lat = self.latent_shape()[2:]
        cond = tuple(self.cond_lat_pair.shape[2:])
        calls = []  # (Sq, Skv, Se) of each self-attention
        for bi in range(nb):
            cross = ucfg.is_cross(bi)
            n_unet = ((2 * lpb + 1) if cross else 0) * depth
            n_cn = (lpb if cross else 0) * depth
            if bi == nb - 1:  # the mid block's transformer
                n_unet += depth
                n_cn += depth
            tc, tl = tokens(cond, bi), tokens(lat, bi)
            calls += [(tc, tc, 0)] * n_unet  # write pass
            calls += [(tl, tl, tc)] * n_unet  # read pass, reference tokens
            calls += [(tl, tl, 0)] * n_cn  # ControlNet
        single = sum(1 for c in calls if c[2] == 0 and routes_to_kernel(*c))
        two = sum(1 for c in calls if c[2] > 0 and routes_to_kernel(*c))
        return {"mlp_fwd": 2 if self.local_grad else 1, "mlp_bwd": 1,
                "flash_attn_single": single, "flash_attn_two_source": two}
