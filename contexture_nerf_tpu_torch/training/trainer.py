"""The SDS paint step and loop, and the setup that feeds them: counterparts
of contexture_nerf_tpu/training/trainer.py `ConTEXTure.define_view_weights`,
`ConTEXTure._calc_text_embeddings`, `ConTEXTure.paint_viewpoint`,
`ConTEXTure.prepare_sds`, `_build_sds_step` (render_grid_latent,
render_grid_latent_local, sds_step) and the loop of `paint_zero123plus`.

`prepare_sds` renders the mesh's 7 fixed views once (K5 rasterizes them in
one launch on the card; K1 queries the MLP on the texture lattice), then
bootstraps the front view: `paint_viewpoint` renders the front pose (K5, K1
again), and the SD2-depth UNet repaints its crop in a 50-step PNDM img2img
(diffusion/sd_depth.py) whose decode is pasted back into the frame. It
crops and resizes that front view into the condition image and the 6
target views into the depth, mask and UV grids, and computes the CLIP and
VAE conditioning. `build_sds_trainer` goes from a config to a ready
`SDSTrainer`: mesh model, MLP, teacher, SD2-depth stack, `prepare_sds`,
trainer. `edit_mask_pts` (guide.reference_texture), `optim.exact_lattice_render`
and the repaint passes of `paint_viewpoint` (paint_step > 1: median fill,
the inpaint UNet) come with later slices.

One step: query the texture MLP at the grid's UVs (the fused kernel on the
card), composite with the mask, VAE-encode and DDPM-noise, run the Zero123++
teacher (write pass, depth ControlNet, read pass, CFG), form the SDS target
and the 1/2-sum-square loss on one sampled latent tile, back-propagate
(through a margin-padded slice with local_sds_grad) and take an Adam step.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import phase, resolve_device
from contexture_nerf_tpu_torch.core.config import (GuideConfig, RenderConfig,
                                                   TrainConfig)
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion.sd_depth import StableDiffusionDepth
from contexture_nerf_tpu_torch.diffusion.unet import UNetConfig
from contexture_nerf_tpu_torch.diffusion.vae import VAEConfig, encode_moments
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, scale_image, scale_latents)
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import groupnorm
from contexture_nerf_tpu_torch.ops.attention import routes_to_kernel
from contexture_nerf_tpu_torch.ops.grid import merge_6_to_grid, split_grid_to_6
from contexture_nerf_tpu_torch.ops.image import (crop_and_resize,
                                                 get_nonzero_region_tuple,
                                                 resize_linear)
from contexture_nerf_tpu_torch.ops.mlp_kernel import (fused_nerf2d,
                                                      fused_nerf2d_emb,
                                                      pad_embedding)
from contexture_nerf_tpu_torch.ops.view_weights import compute_view_weights
from contexture_nerf_tpu_torch.raster.render import RenderCache
from contexture_nerf_tpu_torch.training.views_dataset import \
    Zero123PlusDataset

logger = logging.getLogger("contexture_nerf_tpu_torch")

GUIDANCE_SCALE = 10.0  # reference trainer.py:768
GRAD_SCALE = 0.2  # reference trainer.py:830
MULTIRES = 10
LOG_EVERY = 50  # iterations between logged metrics, as the reference
BOOTSTRAP_STEPS = 50  # img2img_step's num_inference_steps, as the reference


def _to(x, device, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=device, dtype=dtype or t.dtype)


class SDSTrainer:
    """The SDS texture loop of the Zero123++ teacher on one device. `setup`
    is what `prepare_sds` returns. The step's random draws come from
    `generator` (a new one seeded with optim.seed if None), which also
    fills a teacher or MLP made here."""

    def __init__(self, cfg: TrainConfig, setup: Dict, teacher:
                 Optional[Zero123PlusTeacher] = None,
                 mlp: Optional[NeRF2D] = None, tiny: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None):
        dev = self.device = resolve_device(device)
        if cfg.optim.exact_lattice_render:
            raise NotImplementedError(
                "optim.exact_lattice_render samples the texture lattice "
                "through the rasterizer's cache of the 6 target views "
                "(prepare_sds's cache6); a later slice ports it")
        if setup.get("edit_mask_pts") is not None:
            raise NotImplementedError(
                "edit_mask_pts (guide.reference_texture) comes with a later "
                "slice")
        self.cfg = cfg
        self.generator = generator or torch.Generator(
            device=dev).manual_seed(cfg.optim.seed)
        self.teacher = teacher or Zero123PlusTeacher(
            tiny=tiny, device=dev, generator=self.generator)
        self.dtype = self.teacher.dtype
        self.mlp = mlp or NeRF2D(generator=self.generator, device=dev)
        self.mlp.to(dev)
        self.tile_px = self.teacher.tile_px
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
        # contiguous NCHW: a permuted view would carry its channels-last
        # layout through the VAE's convolutions into its GroupNorms (K6)
        img = rgb.reshape(h, w, 3).permute(2, 0, 1)[None].contiguous()
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
        backward once, every teacher self-attention the rule routes to the
        flash kernel (cross-attention's 77 tokens never are), and K6 (one
        launch) for every GroupNorm of the two UNet passes, the ControlNet
        and the VAE encodes (the canvas, and the slice with local_sds_grad);
        the rasterizer never (it runs in prepare_sds)."""
        ucfg = self.teacher.unet_config
        lat = self.latent_shape()[2:]
        cond = tuple(self.cond_lat_pair.shape[2:])
        calls = []  # (Sq, Skv, Se) of each self-attention
        for (level, n_unet), (_, n_cn) in zip(self_attention_levels(ucfg),
                                              self_attention_levels(
                                                  ucfg, controlnet=True)):
            tc, tl = tokens_at(cond, level), tokens_at(lat, level)
            calls += [(tc, tc, 0)] * n_unet  # write pass
            calls += [(tl, tl, tc)] * n_unet  # read pass, reference tokens
            calls += [(tl, tl, 0)] * n_cn  # ControlNet
        single = sum(1 for c in calls if c[2] == 0 and routes_to_kernel(*c))
        two = sum(1 for c in calls if c[2] > 0 and routes_to_kernel(*c))
        encodes = 2 if self.local_grad else 1
        gn = (2 * unet_groupnorms(ucfg) + unet_groupnorms(ucfg, True)
              + encodes * vae_groupnorms(self.teacher.vae_config))
        return {"mlp_fwd": encodes, "mlp_bwd": 1,
                "flash_attn_single": single, "flash_attn_two_source": two,
                "raster": 0, "groupnorm": groupnorm_launches(gn)}


# -- launches derived from the configs ----------------------------------------------

def tokens_at(hw, level: int) -> int:
    """Tokens of a (h, w) latent after `level` stride-2 downsamples."""
    h, w = hw
    for _ in range(level):
        h, w = -(-h // 2), -(-w // 2)
    return h * w


def self_attention_levels(ucfg: UNetConfig, controlnet: bool = False
                          ) -> List[Tuple[int, int]]:
    """(level, self-attentions) of one UNet call (or ControlNet call, which
    has the down and mid blocks only)."""
    nb = len(ucfg.block_out_channels)
    lpb, depth = ucfg.layers_per_block, ucfg.transformer_depth
    out = []
    for bi in range(nb):
        per = lpb if controlnet else 2 * lpb + 1
        n = (per if ucfg.is_cross(bi) else 0) * depth
        if bi == nb - 1:  # the mid block's transformer
            n += depth
        out.append((bi, n))
    return out


def unet_groupnorms(ucfg: UNetConfig, controlnet: bool = False) -> int:
    """GroupNorm calls of one UNet (or ControlNet) call: two in each resnet,
    one in each transformer, and the UNet's conv_norm_out."""
    nb, lpb = len(ucfg.block_out_channels), ucfg.layers_per_block
    n_cross = sum(1 for bi in range(nb) if ucfg.is_cross(bi))
    if controlnet:
        return 2 * (nb * lpb + 2) + n_cross * lpb + 1
    return 2 * (nb * (2 * lpb + 1) + 2) + n_cross * (2 * lpb + 1) + 1 + 1


def groupnorm_launches(calls: int) -> int:
    """K6's launches for `calls` GroupNorm calls on the card, one a call
    whatever the plan (none when the kernel is switched off)."""
    return groupnorm.LAUNCHES_PER_CALL * calls if groupnorm.USE_KERNEL else 0


def vae_groupnorms(vcfg: VAEConfig, decoder: bool = False) -> int:
    """GroupNorm calls of one VAE encode (or decode): two in each resnet,
    the mid attention's, and conv_norm_out."""
    nb, lpb = len(vcfg.block_out_channels), vcfg.layers_per_block
    resnets = nb * (lpb + 1 if decoder else lpb) + 2
    return 2 * resnets + 2


def prepare_sds_kernel_launches(cfg: TrainConfig,
                                teacher: Zero123PlusTeacher,
                                diffusion: Optional[StableDiffusionDepth]
                                ) -> Dict[str, int]:
    """Kernel launches of prepare_sds on the card: K5 and K1 once for the 7
    views, K6 in the two VAE encodes of the condition pair; with the
    bootstrap (`diffusion` given), K5 and K1 once more for the front pose,
    and for each of the PLMS sequence's UNet calls its K3 self-attentions
    and K6 GroupNorms, then K6 in the decode (and in the intermediate
    decodes with log.vis_diffusion_steps); K6 launches once a GroupNorm.
    CLIP's 77 and 257 tokens route to the plain attention path."""
    counts = {k: 0 for k in _build.launch_counts}
    counts["raster"] = counts["mlp_fwd"] = 1
    gn = 2 * vae_groupnorms(teacher.vae_config)
    if diffusion is not None:
        counts["raster"] += 1
        counts["mlp_fwd"] += 1
        steps = len(diffusion.scheduler.timesteps(BOOTSTRAP_STEPS))
        lat = diffusion.latent_shape()[2:]
        single = sum(n for level, n in self_attention_levels(
            diffusion.unet_config)
            if routes_to_kernel(tokens_at(lat, level), tokens_at(lat, level)))
        counts["flash_attn_single"] += steps * single
        decodes = 1 + (min(10, steps) if cfg.log.vis_diffusion_steps else 0)
        gn += (steps * unet_groupnorms(diffusion.unet_config)
               + decodes * vae_groupnorms(diffusion.vae_config, decoder=True))
    counts["groupnorm"] = groupnorm_launches(gn)
    return counts


# -- prepare_sds: mesh -> views -> setup -------------------------------------------

TILE_WEIGHTING = ("uniform", "weighted", "mixed")


def view_angles(render: RenderConfig
                ) -> Tuple[List[float], List[float], List[float]]:
    """(thetas, phis, radii) of the 7 fixed views: the front, then the 6
    Zero123++ targets, phi shifted by render.front_offset."""
    poses = Zero123PlusDataset(render).poses()
    front_offset = np.deg2rad(render.front_offset)
    return ([p["theta"] for p in poses],
            [(p["phi"] - front_offset) % (2 * np.pi) for p in poses],
            [p["radius"] for p in poses])


def define_view_weights(mesh_model: TexturedMeshModel, render: RenderConfig
                        ) -> Tuple[RenderCache, torch.Tensor]:
    """The geometry of the 7 fixed views and their view weights (B,1,H,W)
    bool: True where the pixel's face is seen most head-on in this view."""
    thetas, phis, radii = view_angles(render)
    cache = mesh_model.render_geometry(theta=thetas, phi=phis, radius=radii)
    weights = compute_view_weights(cache.face_idx[:, None],
                                   cache.face_normals[..., 2])
    return cache, weights


def tile_probabilities(object_masks: torch.Tensor, view_weights: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """Sampling probabilities of the 6 grid tiles (views 1..6), from the
    share of each view's foreground pixels whose face it sees best:
    'uniform' (the default), 'weighted' (by that share) or 'mixed' (half
    and half). When no view has such a pixel, the shares fall back to
    uniform. Returns (6,) f32 on the host."""
    if mode not in TILE_WEIGHTING:
        raise ValueError(f"optim.tile_weighting: unknown mode {mode!r} "
                         "(expected uniform|mixed|weighted)")
    fg = object_masks > 0.5
    best = view_weights & fg
    frac = best.sum(dim=(1, 2, 3)) / fg.sum(dim=(1, 2, 3)).clamp(min=1)
    w6 = frac.float().cpu().numpy().astype(np.float64)[1:]
    uniform = np.full(6, 1.0 / 6.0)
    if w6.sum() <= 0:
        if mode != "uniform":
            logger.warning("all view weights are zero; tile_weighting "
                           f"'{mode}' falls back to uniform")
        w6 = uniform.copy()
    w6 = w6 / w6.sum()
    probs = {"uniform": uniform, "weighted": w6,
             "mixed": 0.5 * uniform + 0.5 * w6}[mode]
    return torch.from_numpy((probs / probs.sum()).astype(np.float32))


def condition_eps(teacher: Zero123PlusTeacher, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two normal draws of the VAE posterior samples of the condition
    latents (positive, negative), (1, 4, t/8, t/8) each, in the teacher's
    dtype."""
    lat = teacher.tile_px // teacher.vae_config.downsample
    dev = generator.device
    return tuple(torch.randn((1, teacher.vae_config.latent_channels, lat,
                              lat), generator=generator, device=dev
                             ).to(teacher.dtype) for _ in range(2))


def calc_text_embeddings(cfg: TrainConfig, diffusion: StableDiffusionDepth):
    """(text_z, text_string): the [uncond; cond] pairs of guide.text and of
    guide.text + ", front view", as the reference's trainer computes them
    for the Zero123++ paint path (the only one it paints with)."""
    if not cfg.guide.use_zero123plus or cfg.guide.append_direction:
        raise ValueError("the paint path needs guide.use_zero123plus=True "
                         "and guide.append_direction=False")
    text_string = [cfg.guide.text, cfg.guide.text + ", front view"]
    return [diffusion.get_text_embeds([t]) for t in text_string], text_string


def background_image(guide: GuideConfig, device) -> torch.Tensor:
    """(3, H, W) in [0, 1]: guide.background_img where the file exists (read
    with PIL), otherwise the reference's 64^2 gray."""
    path = Path(guide.background_img)
    if path.exists():
        from PIL import Image

        im = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        return torch.from_numpy(np.ascontiguousarray(
            im.transpose(2, 0, 1))).to(device)
    return torch.full((3, 64, 64), 0.5, device=device)


@torch.no_grad()
def paint_viewpoint(cfg: TrainConfig, mesh_model: TexturedMeshModel,
                    mlp: NeRF2D, diffusion: StableDiffusionDepth, text_z,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first paint step of the front view: render the front pose on the
    background (green with guide.use_background_color, else the background
    image resized to the grid), crop the object's box, repaint the crop by
    SD2-depth img2img (guidance guide.guidance_scale, the seed
    optim.seed, the crop's mask as the update mask; the inpaint UNet only
    serves later paint steps) and paste the result, resized back, into the
    frame. `draws` go to img2img_step. Returns (rgb (1,3,H,W), object mask
    (1,1,H,W)). `timings` receives bootstrap_render, bootstrap_unet,
    bootstrap_decode and bootstrap_paste."""
    dev = mesh_model.device
    pose = Zero123PlusDataset(cfg.render).poses()[0]
    phi = pose["phi"] - np.deg2rad(cfg.render.front_offset)
    phi = float(phi + 2 * np.pi if phi < 0 else phi)
    with phase(timings, "bootstrap_render", dev):
        if cfg.guide.use_background_color:
            background = torch.tensor([0.0, 0.8, 0.0], device=dev)
        else:
            sz = cfg.render.train_grid_size
            background = resize_linear(background_image(cfg.guide, dev)[None],
                                       (sz, sz))
        outputs = mesh_model.render(mlp, theta=[pose["theta"]], phi=[phi],
                                    radius=[pose["radius"]],
                                    background=background)
        rgb_render, object_mask = outputs["image"], outputs["mask"]
        mh, mw, Mh, Mw = get_nonzero_region_tuple(object_mask[0, 0])
        cropped_rgb = rgb_render[:, :, mh:Mh, mw:Mw]
        cropped_depth = outputs["depth"][:, :, mh:Mh, mw:Mw]
        cropped_mask = object_mask[:, :, mh:Mh, mw:Mw]
    out, _ = diffusion.img2img_step(
        text_z[1], cropped_rgb, cropped_depth,
        guidance_scale=cfg.guide.guidance_scale, strength=1.0,
        num_inference_steps=BOOTSTRAP_STEPS, update_mask=cropped_mask,
        fixed_seed=cfg.optim.seed,
        intermediate_vis=cfg.log.vis_diffusion_steps, use_inpaint=False,
        draws=draws, timings=timings)
    with phase(timings, "bootstrap_paste", dev):
        rgb_output = rgb_render.clone()
        rgb_output[:, :, mh:Mh, mw:Mw] = resize_linear(out, (Mh - mh,
                                                             Mw - mw))
    return rgb_output, object_mask


@torch.no_grad()
def prepare_sds(cfg: TrainConfig, mesh_model: TexturedMeshModel, mlp: NeRF2D,
                teacher: Zero123PlusTeacher,
                eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                skip_bootstrap: bool = False,
                generator: Optional[torch.Generator] = None,
                timings: Optional[Dict[str, float]] = None,
                diffusion: Optional[StableDiffusionDepth] = None,
                bootstrap_draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict:
    """The front-view bootstrap, all-view geometry and the one-time teacher
    conditioning: the static setup that `SDSTrainer` takes. The bootstrap
    (`paint_viewpoint` through `diffusion`, the SD2-depth stack) repaints
    the front view that the condition image is cut from; with
    skip_bootstrap the condition image is the current front render. `eps` =
    (eps_cond, eps_neg), the VAE posterior draws of the condition latents;
    drawn from `generator` when None. `bootstrap_draws` go to img2img_step.
    `timings`, when given, receives the wall ms of the phases geometry,
    render, the bootstrap's (bootstrap_text, bootstrap_render,
    bootstrap_unet, bootstrap_decode, bootstrap_paste), crops, vae and clip.

    Returns depth_grid (1,3,3t,2t), mask_grid (1,1,3t,2t), uv_grid_pts
    (6t^2, 2), cond_image (1,3,t,t), cond_lat_pair (2,4,t/8,t/8),
    encoder_hidden_states (2,77,ctx), tile_probs (6,), bboxes6 (the 6
    target views' crop boxes) and front_rgb (1,3,H,W), the front view the
    condition image is cut from."""
    if not skip_bootstrap and diffusion is None:
        raise ValueError("the bootstrap (skip_bootstrap=False) needs the "
                         "SD2-depth stack: pass diffusion=StableDiffusionDepth"
                         "(...)")
    if cfg.optim.exact_lattice_render:
        raise NotImplementedError(
            "optim.exact_lattice_render keeps the rasterizer's cache of the "
            "6 target views (cache6); a later slice ports it")
    if cfg.guide.reference_texture is not None:
        raise NotImplementedError(
            "guide.reference_texture (edit_mask_pts) comes with a later slice")
    dev = mesh_model.device
    tp = teacher.tile_px
    if eps is None:
        eps = condition_eps(teacher, generator or torch.Generator(
            device=dev).manual_seed(cfg.optim.seed))
    eps_cond, eps_neg = (e.to(dev) for e in eps)

    with phase(timings, "geometry", dev):
        cache, view_weights = define_view_weights(mesh_model, cfg.render)
    with phase(timings, "render", dev):
        outputs = mesh_model.render(
            mlp, render_cache=cache,
            background=torch.tensor([0.5, 0.5, 0.5], device=dev))
        object_masks = outputs["mask"]
        depth_maps = 1.0 - outputs["depth"]
    if skip_bootstrap:
        rgb_front, mask_front = outputs["image"][:1], object_masks[:1]
    else:
        with phase(timings, "bootstrap_text", dev):
            text_z, _ = calc_text_embeddings(cfg, diffusion)
        rgb_front, mask_front = paint_viewpoint(
            cfg, mesh_model, mlp, diffusion, text_z, draws=bootstrap_draws,
            timings=timings)
    with phase(timings, "crops", dev):
        masks_np = object_masks[:, 0].cpu().numpy()
        bboxes = [get_nonzero_region_tuple(m) for m in masks_np]
        # the condition image: the front view cropped to tp^2 on gray
        bbox_front = get_nonzero_region_tuple(mask_front[0, 0])
        front_rgb = crop_and_resize(rgb_front, bbox_front, tp, tp)
        front_a = crop_and_resize(mask_front, bbox_front, tp, tp)
        cond_image = front_rgb * front_a + 0.5 * (1 - front_a)
        # the 6 target views: depth on gray, and the mask-weighted UVs
        uv_maps = cache.uv_features.permute(0, 3, 1, 2)
        depth_tiles, uv_tiles, m_tiles = [], [], []
        for i in range(1, len(bboxes)):
            a = crop_and_resize(object_masks[i:i + 1], bboxes[i], tp, tp)
            d = crop_and_resize(depth_maps[i:i + 1], bboxes[i], tp, tp)
            depth_tiles.append(torch.cat([d, d, d], dim=1) * a + 0.5 * (1 - a))
            m = cache.mask[i:i + 1]
            m_t = crop_and_resize(m, bboxes[i], tp, tp)
            uvm = crop_and_resize(uv_maps[i:i + 1] * m, bboxes[i], tp, tp)
            uv_tiles.append(uvm / m_t.clamp(min=1e-6))
            m_tiles.append(m_t)
        depth_grid = merge_6_to_grid(torch.cat(depth_tiles))
        uv_grid = merge_6_to_grid(torch.cat(uv_tiles))
        mask_grid = merge_6_to_grid(torch.cat(m_tiles))
        uv_pts = uv_grid[0].permute(1, 2, 0).reshape(-1, 2).clamp(0.0, 1.0)
    with phase(timings, "vae", dev):
        cond_lat_pair = teacher.encode_condition_pair(cond_image * 2 - 1,
                                                      eps_cond, eps_neg)
    with phase(timings, "clip", dev):
        ehs = teacher.clip_hidden_states(cond_image * 2 - 1)
    tile_probs = tile_probabilities(object_masks, view_weights,
                                    cfg.optim.tile_weighting)
    return {"depth_grid": depth_grid, "mask_grid": mask_grid,
            "uv_grid_pts": uv_pts.contiguous(), "cond_image": cond_image,
            "cond_lat_pair": cond_lat_pair, "encoder_hidden_states": ehs,
            "tile_probs": tile_probs.to(dev), "bboxes6": bboxes[1:],
            "front_rgb": rgb_front}


def build_sds_trainer(cfg: TrainConfig, tiny: bool = False, device="cuda",
                      teacher: Optional[Zero123PlusTeacher] = None,
                      mlp: Optional[NeRF2D] = None,
                      eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      timings: Optional[Dict[str, float]] = None,
                      skip_bootstrap: bool = False,
                      diffusion: Optional[StableDiffusionDepth] = None,
                      bootstrap_draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[SDSTrainer, Dict]:
    """From a config to a ready SDS loop: the mesh model of
    guide.shape_path, the texture MLP, the teacher and (unless
    skip_bootstrap) the SD2-depth stack, each with seeded random weights
    from optim.seed unless given; `prepare_sds` with the front-view
    bootstrap, as the reference's paint loop runs it; then the trainer,
    whose draws continue the same generator. The SD2-depth stack is not
    kept: the loop does not use it. Returns (trainer, setup)."""
    if cfg.guide.initial_texture is not None:
        raise NotImplementedError(
            "guide.initial_texture (fitting the MLP to an image) comes with "
            "a later slice")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(cfg.optim.seed)
    teacher = teacher or Zero123PlusTeacher(tiny=tiny, device=dev,
                                            generator=generator)
    mlp = mlp or NeRF2D(generator=generator, device=dev)
    if not skip_bootstrap and diffusion is None:
        diffusion = StableDiffusionDepth(tiny=tiny, device=dev,
                                         generator=generator)
    mesh_model = TexturedMeshModel(
        cfg.guide, render_grid_size=cfg.render.train_grid_size,
        texture_resolution=cfg.guide.texture_resolution,
        compute_dtype=teacher.dtype, device=dev)
    setup = prepare_sds(cfg, mesh_model, mlp, teacher, eps=eps,
                        skip_bootstrap=skip_bootstrap, generator=generator,
                        timings=timings, diffusion=diffusion,
                        bootstrap_draws=bootstrap_draws)
    trainer = SDSTrainer(cfg, setup, teacher=teacher, mlp=mlp, tiny=tiny,
                         device=dev, generator=generator)
    return trainer, setup
