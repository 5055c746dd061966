"""The paint run: counterparts of contexture_nerf_tpu/training/trainer.py
`ConTEXTure` (setup, `paint`, `paint_zero123plus` with its metrics, images,
checkpoints and resume, the view-consistency metric, `evaluate`,
`full_eval`), of `define_view_weights`, `_calc_text_embeddings`,
`paint_viewpoint`, `prepare_sds` and `_build_sds_step` (render_grid_latent,
render_grid_latent_local, sds_step).

`prepare_sds` renders the mesh's 7 fixed views once (K5 rasterizes them in
one launch on the card; K1 queries the MLP on the texture lattice), then
bootstraps the front view: `paint_viewpoint` renders the front pose (K5, K1
again), and the SD2-depth UNet repaints its crop in a 50-step PNDM img2img
(diffusion/sd_depth.py) whose decode is pasted back into the frame. It
crops and resizes that front view into the condition image and the 6
target views into the depth, mask and UV grids, and computes the CLIP and
VAE conditioning. `build_sds_trainer` goes from a config to a ready
`SDSTrainer`: mesh model (its UV atlas unwrapped and cached for a mesh
without UVs), MLP (fitted to guide.initial_texture, and the change mask of
guide.reference_texture taken, by `seed_texture_field`), teacher, SD2-depth
stack, `prepare_sds`, trainer. `ConTEXTure.paint_viewpoint` paints a
pose as the reference's method does: its repaint passes (paint_step > 1)
render with the median fill and, with guide.use_inpainting, run the
inpaint UNet at 10 < i < 20.

One step: query the texture MLP at the grid's UVs (the fused kernel on the
card), composite with the mask, VAE-encode and DDPM-noise, run the Zero123++
teacher (write pass, depth ControlNet, read pass, CFG), form the SDS target
and the 1/2-sum-square loss on one sampled latent tile, back-propagate
(through a margin-padded slice with local_sds_grad) and take an Adam step.
With guide.reference_texture, the texels it marks as unedited carry no
gradient. optim.exact_lattice_render instead renders the whole texture
lattice through the rasterizer's cache of the 6 target views (K1 forward and
K2 backward over every texel) and takes the full-canvas backward.

The eval renders the turntable (K5 once a frame) with one texture map (K1
once an `evaluate` call: the map depends on the parameters only), filled
with the painted texels' median after painting.

guide.teacher "sv3d_p" swaps the teacher for SV3D_p's video UNet over a
21-frame orbit (training/orbit.py: `prepare_orbit_sds`, `OrbitSDSTrainer`
through `make_sds_trainer`; `step` is this module's), chosen when the
models and the trainer are built; the Zero123++ path is unchanged.

On several ranks (torchrun, optim.data_parallel), `make_mesh` builds the
reference's (views), (views x tp) or (views x sp) mesh. The step splits the
student's query rows into contiguous blocks over `views` (each rank runs
the MLP on its rows), all-gathers the canvas, runs the composite, the VAE
encode, the teacher (its attention through the ring under sp, its towers
sharded under tp) and the loss replicated, and sums the MLP's gradients
over `views` before Adam; every rank draws the same numbers. The eval
renders the turntable in chunks over `views`. Rank 0 writes the run's
files.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import phase, resolve_device
from contexture_nerf_tpu_torch.core import checkpoint as ckpt
from contexture_nerf_tpu_torch.core import profiler
from contexture_nerf_tpu_torch.core.config import (GuideConfig, RenderConfig,
                                                   TrainConfig, dump_config)
from contexture_nerf_tpu_torch.core.imagewriter import (AsyncImageWriter,
                                                        start_host_copy,
                                                        sync_writer)
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion.sd_depth import (SDWeightPaths,
                                                          StableDiffusionDepth)
from contexture_nerf_tpu_torch.diffusion.vae import encode_moments
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, Zero123PlusWeightPaths, scale_image, scale_latents,
    unscale_image)
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops.attention import sequence_parallel
from contexture_nerf_tpu_torch.ops.grid import merge_6_to_grid, split_grid_to_6
from contexture_nerf_tpu_torch.ops.image import (color_with_shade,
                                                 crop_and_resize,
                                                 get_nonzero_region_tuple,
                                                 resize_linear, save_colormap,
                                                 save_gif, save_image,
                                                 tensor2numpy)
from contexture_nerf_tpu_torch.ops.mlp_kernel import (fused_nerf2d,
                                                      fused_nerf2d_emb,
                                                      pad_embedding)
from contexture_nerf_tpu_torch.ops.texture import texture_plan
from contexture_nerf_tpu_torch.ops.view_consistency import \
    compute_view_consistency
from contexture_nerf_tpu_torch.ops.view_weights import compute_view_weights
from contexture_nerf_tpu_torch.parallel import mesh as pmesh
from contexture_nerf_tpu_torch.parallel.tp import shard_params_tp
from contexture_nerf_tpu_torch.raster.render import RenderCache
from contexture_nerf_tpu_torch.training.views_dataset import (
    MultiviewDataset, ViewsDataset, Zero123PlusDataset)

logger = logging.getLogger("contexture_nerf_tpu_torch")

GUIDANCE_SCALE = 10.0  # reference trainer.py:768
GRAD_SCALE = 0.2  # reference trainer.py:830
MULTIRES = 10
LOG_EVERY = 50  # iterations between logged metrics, as the reference
BOOTSTRAP_STEPS = 50  # img2img_step's num_inference_steps, as the reference
FIT_STEPS = 300  # fit_texture_to_image's steps for guide.initial_texture
SP_MIN_SEQ = 256  # sequence_parallel's min_seq, the reference's default


def apply_int8(cfg: TrainConfig, teacher: Zero123PlusTeacher
               ) -> Zero123PlusTeacher:
    """optim.int8_controlnet / optim.int8_teacher onto the teacher's towers
    (W8A8 ControlNet, or UNet and ControlNet), as the reference's
    _init_zero123plus passes them; a given teacher follows the config."""
    teacher.set_int8(cfg.optim.int8_controlnet, cfg.optim.int8_teacher)
    return teacher


def mlp_dtype(teacher_dtype: torch.dtype, device) -> torch.dtype:
    """The texture MLP's compute dtype: the teacher's, but bf16 on the card,
    whose MLP kernels (K1, K2) compute in bf16 only; so a tiny (f32)
    teacher runs there too."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else teacher_dtype


def make_mesh(cfg: TrainConfig):
    """The device mesh of the step and the eval, as the reference's
    `_make_mesh` builds it over the ranks of torch.distributed (one rank
    when it is not initialised): None with optim.data_parallel 'off' or one
    rank; over every rank with 'on', and with 'auto' only when the ranks
    are on CUDA (the reference's 'auto' builds one on its accelerator
    only). optim.tensor_parallel / sequence_parallel > 1 make it (n/tp, tp)
    as ("views", "tp") or (n/sp, sp) as ("views", "sp"); both at once, a
    degree that does not divide n, or either where no mesh is built
    raise, in the reference's words."""
    dp = cfg.optim.data_parallel
    tp = max(1, int(cfg.optim.tensor_parallel))
    sp = max(1, int(cfg.optim.sequence_parallel))
    if tp > 1 and sp > 1:
        raise ValueError("optim.tensor_parallel and "
                         "optim.sequence_parallel are mutually exclusive")
    n = pmesh.world_size()
    if n <= 1 or dp == "off":
        if tp > 1 or sp > 1:
            raise ValueError(
                f"optim.tensor_parallel={tp}/sequence_parallel={sp} "
                f"requested but no mesh can be built (data_parallel={dp!r}, "
                f"{n} ranks) — an explicit TP/SP request must not be "
                "silently ignored")
        return None
    if dp == "on" or (dp == "auto" and pmesh.device_type() == "cuda"):
        for k, axis, name in ((tp, "tp", "tensor_parallel"),
                              (sp, "sp", "sequence_parallel")):
            if k > 1:
                if n % k:
                    raise ValueError(f"optim.{name}={k} does not divide "
                                     f"the {n} ranks")
                return pmesh.create_mesh((n // k, k), ("views", axis))
        return pmesh.create_mesh((n,), ("views",))
    if tp > 1 or sp > 1:
        raise ValueError(
            f"optim.tensor_parallel={tp}/sequence_parallel={sp} requested "
            f"but data_parallel='auto' builds no mesh on the "
            f"{pmesh.device_type()} backend — set optim.data_parallel='on' "
            "to force one")
    return None


def _to(x, device, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=device, dtype=dtype or t.dtype)


class SDSTrainer:
    """The SDS texture loop of the Zero123++ teacher. `setup` is what
    `prepare_sds` returns. The step's random draws come from `generator` (a
    new one seeded with optim.seed if None), which also fills a teacher or
    MLP made here. optim.exact_lattice_render renders the texture map of
    `mesh_model` through setup's cache6 and turns local_sds_grad off, as
    the reference does. `mesh` is the device mesh of the step:
    make_mesh(cfg) by default, None for this rank alone; with a `tp` axis
    of size > 1 the teacher's UNet, ControlNet and VAE encoder are sharded
    here (parallel/tp.py)."""

    def __init__(self, cfg: TrainConfig, setup: Dict, teacher:
                 Optional[Zero123PlusTeacher] = None,
                 mlp: Optional[NeRF2D] = None, tiny: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 mesh_model: Optional[TexturedMeshModel] = None,
                 mesh="config"):
        self.exact = bool(cfg.optim.exact_lattice_render)
        if self.exact and (mesh_model is None
                           or setup.get("cache6") is None):
            raise ValueError(
                "optim.exact_lattice_render renders the mesh model's "
                "texture map through the rasterizer's cache of the 6 target "
                "views: pass mesh_model and a setup from prepare_sds with "
                "exact_lattice_render on (its cache6)")
        self._init_common(cfg, Zero123PlusTeacher, teacher, mlp, tiny,
                          device, generator, mesh_model, mesh)
        dev = self.device
        if self.tp > 1:
            for tower in (self.teacher.unet, self.teacher.controlnet,
                          self.teacher.vae_encoder):
                shard_params_tp(tower, self.mesh, "tp")
        self.tile_px = self.teacher.tile_px
        self.lat_tile = self.tile_px // self.vae_down
        self.grid_hw = (3 * self.tile_px, 2 * self.tile_px)
        opt = cfg.optim
        self.local_grad = bool(opt.local_sds_grad)
        if self.local_grad and self.exact:
            logger.warning(
                "optim.exact_lattice_render is on: disabling "
                "optim.local_sds_grad (it requires the fused-query render "
                "path); gradients follow the reference-exact full-canvas "
                "backward")
            self.local_grad = False
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
        self.cond_lat_pair = _to(setup["cond_lat_pair"], dev, self.dtype)
        self.ehs = _to(setup["encoder_hidden_states"], dev, self.dtype)
        self.tile_probs = _to(setup["tile_probs"], dev, torch.float32)
        if self.exact:
            self.cache6 = RenderCache(*(_to(x, dev) for x in setup["cache6"]))
            # the sampler's transpose at the 6 views' fixed UVs, for K7's
            # backward: built once here, so no step sorts
            res = mesh_model.texture_resolution
            self.texture_plan = texture_plan(
                self.cache6.uv_features.contiguous(),
                self.cache6.mask.contiguous(), (res, res),
                mesh_model.renderer.interpolation_mode)
            self.bboxes6 = [tuple(int(v) for v in b)
                            for b in setup["bboxes6"]]
            self.mask_grid = self.uv_pts = self.emb_pts = None
            self.edit_mask = None
        else:
            self.mask_grid = _to(setup["mask_grid"], dev, torch.float32)
            self.uv_pts = _to(setup["uv_grid_pts"], dev,
                              torch.float32).contiguous()
            self.emb_pts = (pad_embedding(self.uv_pts, MULTIRES,
                                          dtype=self.mlp_dtype)
                            if opt.precompute_uv_embedding else None)
            # guide.reference_texture: the change mask at the grid's UVs
            self.edit_mask = _to(setup.get("edit_mask_pts"), dev,
                                 torch.float32)
        lat_hw = (self.depth_grid.shape[2] // self.vae_down,
                  self.depth_grid.shape[3] // self.vae_down)
        with torch.no_grad():
            # loop-invariant ControlNet hint embedding, hoisted
            self.cn_cond_emb = self.teacher.embed_control_cond(
                self.depth_grid, lat_hw)

    def _init_common(self, cfg, teacher_cls, teacher, mlp, tiny, device,
                     generator, mesh_model, mesh):
        """What the trainer of every view layout holds: the device, the
        mesh and its axis sizes, the generator, the teacher (a
        `teacher_cls` made from the generator when None; W8A8 where the
        config asks), the MLP and its dtype, the teacher's noise table and
        Adam over the MLP."""
        dev = self.device = resolve_device(device)
        self.mesh = make_mesh(cfg) if mesh == "config" else mesh
        self.n_views = pmesh.axis_size(self.mesh, "views")
        self.sp = pmesh.axis_size(self.mesh, "sp")
        self.tp = pmesh.axis_size(self.mesh, "tp")
        self._grad_rows_split = False
        self.mesh_model = mesh_model
        self.cfg = cfg
        self.generator = generator or torch.Generator(
            device=dev).manual_seed(cfg.optim.seed)
        self.teacher = apply_int8(cfg, teacher or teacher_cls(
            tiny=tiny, device=dev, generator=self.generator))
        self.dtype = self.teacher.dtype
        self.mlp_dtype = mlp_dtype(self.dtype, dev)
        self.mlp = mlp or NeRF2D(generator=self.generator, device=dev)
        self.mlp.to(dev)
        self.vae_down = self.teacher.vae_config.downsample
        self.acp = self.teacher.alphas_cumprod
        opt = cfg.optim
        # capturable on the card: Adam keeps its step counts there and
        # reads none back (else two `.item()` of each leaf's count a step)
        self.optimizer = torch.optim.Adam(
            self.mlp.parameters(), lr=opt.sds_lr,
            betas=tuple(opt.sds_betas), eps=opt.sds_eps,
            capturable=dev.type == "cuda")

    # -- student render ------------------------------------------------------

    def _query(self, window=None):
        """Texture colours in [0,1] at the grid's UVs, or at the window
        (oy, ox, h, w) of the grid, through the fused MLP. With an edit
        mask m (guide.reference_texture), m rgb + (1 - m) rgb.detach():
        the unedited texels carry no gradient. Under a mesh, rows that the
        `views` size divides are split into contiguous blocks: each rank
        queries its block, and the colours are all-gathered."""
        H, W = self.grid_hw
        src = self.emb_pts if self.emb_pts is not None else self.uv_pts
        m = self.edit_mask
        if window is not None:
            oy, ox, h, w = window

            def cut(x):
                return x.reshape(H, W, -1)[oy:oy + h, ox:ox + w].reshape(
                    h * w, -1).contiguous()

            src = cut(src)
            m = cut(m) if m is not None else None
        split = self.mesh is not None and src.shape[0] % self.n_views == 0
        if split:
            src, m = pmesh.shard_leading_axis((src, m), self.mesh)
        if torch.is_grad_enabled():
            self._grad_rows_split = split
        fn = fused_nerf2d_emb if self.emb_pts is not None else fused_nerf2d
        out = fn(self.mlp, src, MULTIRES, compute_dtype=self.mlp_dtype)
        rgb = (torch.tanh(out) + 1.0) / 2.0
        if m is not None:
            rgb = m * rgb + (1 - m) * rgb.detach()
        if split:
            rgb = pmesh.gather_rows(rgb, self.mesh.get_group("views"))
        return rgb

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
        rgb). With exact_lattice_render the canvas is the texture map
        (the MLP over the whole lattice) sampled at the 6 views' cached
        UVs, composited on grey, each view cropped to its box and resized
        to the tile; rgb is then the texture map."""
        with profiler.span("sds.render"):
            grid, rgb = self._render_canvas()
        with profiler.span("sds.encode"):
            return self._encode(grid, eps), grid, rgb

    def _render_canvas(self):
        """(grid, rgb) of render_grid_latent, before the encode."""
        if not self.exact:
            rgb = self._query()
            return self._composite(rgb, *self.grid_hw, self.mask_grid), rgb
        texture, _ = self.mesh_model.get_texture_map(self.mlp)
        image, mask, _, _ = self.mesh_model.renderer.render_texture_with_cache(
            self.cache6, texture, "none", plan=self.texture_plan)
        image = torch.clamp(image * mask + 0.5 * (1 - mask), 0.0, 1.0)
        tiles = [crop_and_resize(image[i:i + 1], self.bboxes6[i],
                                 self.tile_px, self.tile_px)
                 for i in range(len(self.bboxes6))]
        grid = merge_6_to_grid(torch.cat(tiles)).contiguous()
        return scale_image(grid * 2 - 1), texture

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
        with profiler.span("sds.render"):
            rgb_sl = self._query((oy, ox, sl_h, sl_w))
            mask_sl = self.mask_grid[:, :, oy:oy + sl_h, ox:ox + sl_w]
            patch = self._composite(rgb_sl, sl_h, sl_w, mask_sl)
            grid = grid_full.clone()
            grid[:, :, oy:oy + sl_h, ox:ox + sl_w] = patch.to(grid_full.dtype)
            g_sl = grid[:, :, oy:oy + sl_h, ox:ox + sl_w]
        with profiler.span("sds.encode"):
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
        does, params being the updated MLP state. Under the profiler the
        step is the span `sds.step`, cut whole into `sds.draw`,
        `sds.render` / `sds.encode`, `sds.teacher`, `sds.loss`,
        `sds.backward`, `sds.adam` and `sds.out`; its one sync is
        `sync.tile_idx`."""
        with profiler.span("sds.step"):
            dev = self.device
            with profiler.span("sds.draw"):
                d = self.draw() if draws is None else draws
                tile_idx = profiler.host_read(d["tile_idx"], "tile_idx")
                eps = _to(d["eps"], dev)
                noise = _to(d["noise"], dev, torch.float32)
                neg_noise = _to(d.get("neg_noise"), dev)
                cond_noise = _to(d.get("cond_noise"), dev)
                t_t = torch.tensor([int(t)], device=dev)
            if self.local_grad:
                z, grid, _ = self.render_grid_latent_local(eps, tile_idx)
            else:
                z, grid, _ = self.render_grid_latent(eps)
            z_sg = z.detach()
            with profiler.span("sds.teacher"):
                v_pred = self._teacher(z_sg, noise, t_t, neg_noise,
                                       cond_noise)
            with profiler.span("sds.loss"):
                v = sch.velocity_target(self.acp, z_sg, noise, t_t)
                acp_t = self.acp[t_t].reshape(-1, 1, 1, 1)
                w = 1 - acp_t
                g = torch.nan_to_num(
                    GRAD_SCALE * w * torch.sqrt(acp_t) * (v_pred - v))
                targets = (z_sg - g).detach()
                loss = self._sds_loss(z, targets, tile_idx)
            with profiler.span("sds.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                grads = [p.grad for p in self.mlp.parameters()]
                if self._grad_rows_split:
                    # each rank's gradient is its rows' share: sum over
                    # `views`
                    group = self.mesh.get_group("views")
                    for gr in grads:
                        pmesh.all_reduce_sum(gr, group)
            with profiler.span("sds.adam"):
                grad_norm = torch.sqrt(
                    sum(torch.sum(gr.float() ** 2) for gr in grads))
                self.optimizer.step()
            with profiler.span("sds.out"):
                fisher = torch.sum(
                    (torch.sqrt(acp_t) /
                     torch.clamp(torch.sqrt(1 - acp_t), min=1e-8)) ** 2
                    * torch.abs(v_pred - v) ** 2)
                params = {k: p.detach().clone()
                          for k, p in self.mlp.state_dict().items()}
            return (params, loss.detach(), grad_norm.detach(), fisher,
                    grid.detach())

    def _sds_loss(self, z, targets, tile_idx: int):
        """1/2 sum of squares over the sampled tile, over the batch."""
        z_tiles = split_grid_to_6(z, self.lat_tile)
        tgt_tiles = split_grid_to_6(targets, self.lat_tile)
        return 0.5 * torch.sum(
            (z_tiles[tile_idx] - tgt_tiles[tile_idx]) ** 2) / z.shape[0]

    def canvas_rgb(self, grid):
        """The step's canvas in [0, 1], for the logged images."""
        return (unscale_image(grid) + 1) / 2

    def _teacher(self, z_sg, noise, t_t, neg_noise, cond_noise):
        """The teacher's CFG v-prediction at the DDPM-noised latent."""
        latents_noisy = sch.add_noise(self.acp, z_sg, noise, t_t)
        tch = self.teacher
        with (sequence_parallel(self.mesh, "sp", SP_MIN_SEQ) if self.sp > 1
              else contextlib.nullcontext()):
            if self.individual:
                return tch._cfg_v_pred_individual(
                    latents_noisy, t_t, self.cond_lat_pair, self.ehs,
                    self.depth_grid, self.gs_i, self.gs_t, neg_noise,
                    cond_noise, cn_cond_emb=self.cn_cond_emb)
            return tch.teacher_v_pred(
                latents_noisy, t_t, self.cond_lat_pair, self.ehs,
                self.depth_grid, GUIDANCE_SCALE, neg_noise, cond_noise,
                cn_cond_emb=self.cn_cond_emb)

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
            if logs_metrics(i, n):
                metrics.append({
                    "iter": i, "t": ts[i],
                    "sds_loss": profiler.host_read(loss, "loss"),
                    "grad_norm": profiler.host_read(grad_norm, "grad_norm"),
                    "fisher_divergence_t": profiler.host_read(fisher,
                                                              "fisher")})
        return metrics


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
    """Sampling probabilities of the 6 grid tiles (views 1..6 of the 7
    fixed views): `view_probabilities` of those views. Returns (6,) f32 on
    the host."""
    return view_probabilities(object_masks[1:], view_weights[1:], mode)


def view_probabilities(object_masks: torch.Tensor, view_weights: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """Sampling probabilities of n views (the grid's tiles, an orbit's
    frames), from the share of each view's foreground pixels whose face it
    sees best: 'uniform' (the default), 'weighted' (by that share) or
    'mixed' (half and half). When no view has such a pixel, the shares fall
    back to uniform. Returns (n,) f32 on the host."""
    if mode not in TILE_WEIGHTING:
        raise ValueError(f"optim.tile_weighting: unknown mode {mode!r} "
                         "(expected uniform|mixed|weighted)")
    fg = object_masks > 0.5
    best = view_weights & fg
    frac = best.sum(dim=(1, 2, 3)) / fg.sum(dim=(1, 2, 3)).clamp(min=1)
    w = frac.float().cpu().numpy().astype(np.float64)
    n = w.shape[0]
    uniform = np.full(n, 1.0 / n)
    if w.sum() <= 0:
        if mode != "uniform":
            logger.warning("all view weights are zero; tile_weighting "
                           f"'{mode}' falls back to uniform")
        w = uniform.copy()
    w = w / w.sum()
    probs = {"uniform": uniform, "weighted": w,
             "mixed": 0.5 * uniform + 0.5 * w}[mode]
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
                    timings: Optional[Dict[str, float]] = None,
                    paint_step: int = 1, pose: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               List[torch.Tensor]]:
    """One paint step of a pose (the front view's when None): render it on
    the background (green with guide.use_background_color, else the
    background image resized to the grid), crop the object's box, repaint
    the crop by SD2-depth img2img (guidance guide.guidance_scale, the seed
    optim.seed, the crop's mask as the update mask) and paste the result,
    resized back, into the frame. A repaint pass (paint_step > 1) renders
    with the median fill, and with guide.use_inpainting its img2img runs
    the inpaint UNet at 10 < i < 20. `draws` go to img2img_step. Returns
    (rgb (1,3,H,W), object mask (1,1,H,W), the render (1,3,H,W), the
    intermediate images of log.vis_diffusion_steps). `timings` receives
    bootstrap_render, bootstrap_unet, bootstrap_decode and
    bootstrap_paste."""
    dev = mesh_model.device
    pose = pose or Zero123PlusDataset(cfg.render).poses()[0]
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
                                    background=background,
                                    use_median=paint_step > 1)
        rgb_render, object_mask = outputs["image"], outputs["mask"]
        mh, mw, Mh, Mw = get_nonzero_region_tuple(object_mask[0, 0])
        cropped_rgb = rgb_render[:, :, mh:Mh, mw:Mw]
        cropped_depth = outputs["depth"][:, :, mh:Mh, mw:Mw]
        cropped_mask = object_mask[:, :, mh:Mh, mw:Mw]
    out, intermediates = diffusion.img2img_step(
        text_z[1], cropped_rgb, cropped_depth,
        guidance_scale=cfg.guide.guidance_scale, strength=1.0,
        num_inference_steps=BOOTSTRAP_STEPS, update_mask=cropped_mask,
        fixed_seed=cfg.optim.seed,
        intermediate_vis=cfg.log.vis_diffusion_steps,
        use_inpaint=cfg.guide.use_inpainting and paint_step > 1,
        draws=draws, timings=timings)
    with phase(timings, "bootstrap_paste", dev):
        rgb_output = rgb_render.clone()
        rgb_output[:, :, mh:Mh, mw:Mw] = resize_linear(out, (Mh - mh,
                                                             Mw - mw))
    return rgb_output, object_mask, rgb_render, intermediates


def prepare_sds(cfg: TrainConfig, mesh_model: TexturedMeshModel, mlp: NeRF2D,
                teacher, eps=None, skip_bootstrap: bool = False,
                generator: Optional[torch.Generator] = None,
                timings: Optional[Dict[str, float]] = None,
                diffusion: Optional[StableDiffusionDepth] = None,
                bootstrap_draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict:
    """The static setup of guide.teacher's SDS loop (`teacher_path`):
    `prepare_grid_sds` for Zero123++, `orbit.prepare_orbit_sds` for
    SV3D_p (eps is then the condition image's augmentation draw, (1, 3, P,
    P))."""
    return teacher_path(cfg).prepare(cfg, mesh_model, mlp, teacher, eps,
                                     skip_bootstrap, generator, timings,
                                     diffusion, bootstrap_draws)


@torch.no_grad()
def prepare_grid_sds(cfg: TrainConfig, mesh_model: TexturedMeshModel,
                     mlp: NeRF2D, teacher: Zero123PlusTeacher,
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
    (6t^2, 2), edit_mask_pts (6t^2, 1) (the mesh model's edit_change_mask
    at the grid's UVs, or None), cond_image (1,3,t,t), cond_lat_pair
    (2,4,t/8,t/8), encoder_hidden_states (2,77,ctx), tile_probs (6,),
    bboxes6 (the 6 target views' crop boxes), cache6 (None) and front_rgb
    (1,3,H,W), the front view the condition image is cut from. With
    optim.exact_lattice_render, as in the reference, cache6 is the 6 target
    views' `RenderCache` and mask_grid, uv_grid_pts and edit_mask_pts are
    None: the step renders the texture lattice through the cache."""
    if not skip_bootstrap and diffusion is None:
        raise ValueError("the bootstrap (skip_bootstrap=False) needs the "
                         "SD2-depth stack: pass diffusion=StableDiffusionDepth"
                         "(...)")
    exact = bool(cfg.optim.exact_lattice_render)
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
        rgb_front, mask_front, _, _ = paint_viewpoint(
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
            if exact:
                continue
            m = cache.mask[i:i + 1]
            m_t = crop_and_resize(m, bboxes[i], tp, tp)
            uvm = crop_and_resize(uv_maps[i:i + 1] * m, bboxes[i], tp, tp)
            uv_tiles.append(uvm / m_t.clamp(min=1e-6))
            m_tiles.append(m_t)
        depth_grid = merge_6_to_grid(torch.cat(depth_tiles))
        mask_grid = uv_pts = edit_pts = None
        if not exact:
            uv_grid = merge_6_to_grid(torch.cat(uv_tiles))
            mask_grid = merge_6_to_grid(torch.cat(m_tiles))
            uv_pts = uv_grid[0].permute(1, 2, 0).reshape(-1, 2).clamp(
                0.0, 1.0).contiguous()
            change = mesh_model.edit_change_mask
            if change is not None:
                # the lattice's row is v (res - 1), its column u (res - 1)
                res = change.shape[-1]
                edit_pts = map_coordinates_linear(
                    change[0].to(dev), uv_pts[:, 1] * (res - 1),
                    uv_pts[:, 0] * (res - 1))[:, None]
    with phase(timings, "vae", dev):
        cond_lat_pair = teacher.encode_condition_pair(cond_image * 2 - 1,
                                                      eps_cond, eps_neg)
    with phase(timings, "clip", dev):
        ehs = teacher.clip_hidden_states(cond_image * 2 - 1)
    tile_probs = tile_probabilities(object_masks, view_weights,
                                    cfg.optim.tile_weighting)
    return {"depth_grid": depth_grid, "mask_grid": mask_grid,
            "uv_grid_pts": uv_pts, "edit_mask_pts": edit_pts,
            "cond_image": cond_image,
            "cond_lat_pair": cond_lat_pair, "encoder_hidden_states": ehs,
            "tile_probs": tile_probs.to(dev), "bboxes6": bboxes[1:],
            "cache6": (RenderCache(*(x[1:] for x in cache)) if exact
                       else None),
            "front_rgb": rgb_front}


def map_coordinates_linear(img: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor) -> torch.Tensor:
    """`img` (H, W) at the points (rows, cols) by bilinear interpolation,
    0 outside: jax.scipy.ndimage.map_coordinates(img, [rows, cols],
    order=1) (mode "constant", cval 0), its terms in its order."""
    nodes = []
    for c in (rows, cols):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.long()
        nodes.append(((i, 1 - upper_w), (i + 1, upper_w)))
    H, W = img.shape
    out = None
    for (iy, wy), (ix, wx) in itertools.product(*nodes):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        v = img[iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
        term = wy * wx * torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
        out = term if out is None else out + term
    return out


def _config_path(guide: GuideConfig, key: str) -> Optional[str]:
    """guide.<key> when set; a path that does not exist raises."""
    path = getattr(guide, key)
    if path and not os.path.exists(str(path)):
        raise FileNotFoundError(f"guide.{key}: {path} does not exist")
    return str(path) if path else None


def sd_weight_paths(guide: GuideConfig) -> Optional[SDWeightPaths]:
    """The SD2-depth stack's snapshot paths, as the reference's
    _init_diffusion resolves them: guide.diffusion_name when it is a local
    directory (otherwise it names a hub model: random towers), and
    guide.inpaint_model_path. None when neither is given."""
    name = str(guide.diffusion_name)
    sd_root = name if os.path.isdir(name) else None
    inpaint_root = _config_path(guide, "inpaint_model_path")
    if sd_root or inpaint_root:
        return SDWeightPaths.from_snapshot(sd_root, inpaint_root)
    return None


def zero123plus_weight_paths(guide: GuideConfig
                             ) -> Optional[Zero123PlusWeightPaths]:
    """The teacher's snapshot paths from guide.zero123plus_path and
    guide.controlnet_path, as the reference's _init_zero123plus resolves
    them. None when neither is given."""
    root = _config_path(guide, "zero123plus_path")
    controlnet_root = _config_path(guide, "controlnet_path")
    if root or controlnet_root:
        return Zero123PlusWeightPaths.from_snapshot(root, controlnet_root)
    return None


def _loaded_line(what: str, wp, loaded: Dict[str, dict]) -> str:
    towers = ", ".join(f"{k} {v['bytes'] / 1e9:.3f} GB in {v['seconds']:.2f} s"
                       for k, v in loaded.items())
    return f"{what} weights from snapshot: {wp}; loaded {towers or 'none'}"


def load_texture_image(path, res: int) -> Optional[torch.Tensor]:
    """The image at `path` as (3, res, res) f32 in [0, 1] on the host, read
    and resized by Pillow as the reference's _load_texture_image does; None
    (with a warning) when the file does not exist."""
    from PIL import Image

    p = Path(path)
    if not p.exists():
        logger.warning(f"texture image {p} not found; skipping")
        return None
    im = np.asarray(Image.open(p).convert("RGB").resize((res, res)),
                    np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(im.transpose(2, 0, 1)))


def seed_texture_field(cfg: TrainConfig, mesh_model: TexturedMeshModel,
                       mlp: NeRF2D,
                       generator: Optional[torch.Generator]) -> None:
    """guide.initial_texture: fit the MLP to the image
    (`fit_texture_to_image`, its UVs drawn from `generator`).
    guide.reference_texture: the texels where the image and the current
    texture map differ by more than 0.1 (summed over channels) become the
    mesh model's edit_change_mask (1, res, res); `prepare_sds` samples it
    at the grid's UVs. A file that does not exist is skipped with a
    warning, as in the reference."""
    res = mesh_model.texture_resolution
    init = cfg.guide.initial_texture
    if init is not None:
        img = load_texture_image(init, res)
        if img is not None:
            mesh_model.fit_texture_to_image(mlp, img, steps=FIT_STEPS,
                                            generator=generator)
            logger.info(f"Seeded texture field from {init}")
    mesh_model.edit_change_mask = None
    ref = cfg.guide.reference_texture
    if ref is not None:
        base = load_texture_image(ref, res)
        if base is not None:
            with torch.no_grad():
                current, _ = mesh_model.get_texture_map(mlp)
            diff = (base.to(current)[None] - current).abs().sum(dim=1)
            mesh_model.edit_change_mask = (diff > 0.1).float()


def build_models(cfg: TrainConfig, tiny: bool = False, device="cuda",
                 teacher: Optional[Zero123PlusTeacher] = None,
                 mlp: Optional[NeRF2D] = None,
                 diffusion: Optional[StableDiffusionDepth] = None,
                 skip_bootstrap: bool = False):
    """The models of a paint run: (generator, teacher, mlp, diffusion,
    mesh_model). The generator is seeded with optim.seed and fills, in
    this order, the teacher and the texture MLP (each unless given), then
    `seed_texture_field` draws the fit's UVs (guide.initial_texture only),
    then the SD2-depth stack (unless given or skip_bootstrap). The mesh
    model is guide.shape_path's, its atlas cached under
    cache/<shape stem>/ for a mesh without UVs. Towers with a snapshot in
    the config (guide.zero123plus_path, controlnet_path, diffusion_name,
    inpaint_model_path) then load it, so the generator's stream, and with
    it the MLP and every later draw, does not depend on what loads; a
    guide.concept_path that exists adds its concept to the SD2 text
    tower. optim.int8_controlnet / int8_teacher set the teacher's W8A8
    towers (`apply_int8`). Under several ranks each builds the same models
    from the same seed; only rank 0 writes the atlas cache."""
    make_mesh(cfg)
    dev = resolve_device(device)
    z_wp = zero123plus_weight_paths(cfg.guide)
    sd_wp = sd_weight_paths(cfg.guide)
    generator = torch.Generator(device=dev).manual_seed(cfg.optim.seed)
    if teacher is None:
        teacher = teacher_path(cfg).teacher(
            tiny=tiny, device=dev, generator=generator, weight_paths=z_wp)
        if z_wp is not None:
            logger.info(_loaded_line("Zero123++", z_wp, teacher.loaded))
    apply_int8(cfg, teacher)
    mlp = mlp or NeRF2D(generator=generator, device=dev)
    mesh_model = TexturedMeshModel(
        cfg.guide, render_grid_size=cfg.render.train_grid_size,
        texture_resolution=cfg.guide.texture_resolution,
        cache_path=Path("cache") / Path(cfg.guide.shape_path).stem,
        compute_dtype=mlp_dtype(teacher.dtype, dev), device=dev,
        write_cache=pmesh.is_writer())
    seed_texture_field(cfg, mesh_model, mlp, generator)
    if not skip_bootstrap and diffusion is None:
        diffusion = StableDiffusionDepth(
            tiny=tiny, device=dev, generator=generator, weight_paths=sd_wp,
            min_timestep=cfg.optim.min_timestep,
            max_timestep=cfg.optim.max_timestep, no_noise=cfg.optim.no_noise)
        if sd_wp is not None:
            logger.info(_loaded_line("SD2", sd_wp, diffusion.loaded))
        cp = cfg.guide.concept_path
        if cp is not None and Path(cp).exists():
            diffusion.load_concept(str(cp))
            logger.info(f"Loaded textual-inversion concept from {cp}")
    return generator, teacher, mlp, diffusion, mesh_model


def build_sds_trainer(cfg: TrainConfig, tiny: bool = False, device="cuda",
                      teacher: Optional[Zero123PlusTeacher] = None,
                      mlp: Optional[NeRF2D] = None,
                      eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      timings: Optional[Dict[str, float]] = None,
                      skip_bootstrap: bool = False,
                      diffusion: Optional[StableDiffusionDepth] = None,
                      bootstrap_draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[SDSTrainer, Dict]:
    """From a config to a ready SDS loop: `build_models` (seeded random
    weights from optim.seed unless given); `prepare_sds` with the
    front-view bootstrap, as the reference's paint loop runs it; then the
    trainer, whose draws continue the same generator. The SD2-depth stack
    is not kept: the loop does not use it. Returns (trainer, setup)."""
    dev = resolve_device(device)
    generator, teacher, mlp, diffusion, mesh_model = build_models(
        cfg, tiny, dev, teacher, mlp, diffusion, skip_bootstrap)
    setup = prepare_sds(cfg, mesh_model, mlp, teacher, eps=eps,
                        skip_bootstrap=skip_bootstrap, generator=generator,
                        timings=timings, diffusion=diffusion,
                        bootstrap_draws=bootstrap_draws)
    trainer = make_sds_trainer(cfg, setup, teacher=teacher, mlp=mlp,
                               tiny=tiny, device=dev, generator=generator,
                               mesh_model=mesh_model)
    return trainer, setup


def make_sds_trainer(cfg: TrainConfig, setup: Dict, **kwargs) -> SDSTrainer:
    """The SDS loop of guide.teacher (`teacher_path`): `SDSTrainer` over
    the Zero123++ grid, or `orbit.OrbitSDSTrainer` over SV3D_p's orbit;
    the keyword arguments are SDSTrainer's."""
    return teacher_path(cfg).trainer(cfg, setup, **kwargs)


class TeacherPath(NamedTuple):
    """What guide.teacher selects: the teacher's class, the static setup
    (prepare_sds's signature) and the trainer's class."""
    teacher: type
    prepare: Callable
    trainer: type


def teacher_path(cfg: TrainConfig) -> TeacherPath:
    """guide.teacher's path; SV3D_p's modules are imported only when the
    config asks for them."""
    if cfg.guide.teacher == "sv3d_p":
        from contexture_nerf_tpu_torch.diffusion.sv3d import SV3DTeacher
        from contexture_nerf_tpu_torch.training import orbit

        return TeacherPath(SV3DTeacher, orbit.prepare_orbit_sds,
                           orbit.OrbitSDSTrainer)
    return TeacherPath(Zero123PlusTeacher, prepare_grid_sds, SDSTrainer)


# -- the eval render -----------------------------------------------------------------

def eval_frame(mesh_model: TexturedMeshModel, texture: torch.Tensor, theta,
               phi, radius, dim: int):
    """One eval render of `texture` (1,3,R,R) at (theta, phi, radius) on
    white: the pixels left at the default colour are shaded grey by their
    z normal, the image clipped to [0, 1]. Returns (rgb (B,dim,dim,3),
    depth (B,dim,dim,1), z_normals (B,1,dim,dim))."""
    outputs = mesh_model.render_texture(texture, theta=theta, phi=phi,
                                        radius=radius, dims=(dim, dim),
                                        background="white")
    z_normals = outputs["normals"][:, -1:].clamp(0, 1)
    rgb_render = outputs["image"]
    default = torch.tensor(mesh_model.default_color, dtype=rgb_render.dtype,
                           device=rgb_render.device).reshape(1, 3, 1, 1)
    diff = (rgb_render - default).abs().sum(dim=1)
    uncolored = (diff < 0.1).to(rgb_render.dtype)[:, None]
    shade = color_with_shade([0.85, 0.85, 0.85], z_normals, light_coef=0.3)
    rgb_render = rgb_render * (1 - uncolored) + shade * uncolored
    rgb = rgb_render.permute(0, 2, 3, 1).clamp(0, 1)
    depth = outputs["depth"].permute(0, 2, 3, 1)
    return rgb, depth, z_normals


# -- the paint run -------------------------------------------------------------------

def logs_metrics(i: int, iterations: int) -> bool:
    """A metric entry (and a sync-to-sync window) at iteration i."""
    return i % LOG_EVERY == 0 or i == iterations - 1


def logs_view_consistency(i: int, iterations: int) -> bool:
    """The view-consistency metric in iteration i's entry."""
    return i % 250 == 0 or i == iterations - 1


def logs_images(i: int) -> bool:
    """The texture map and the rendered grid written at iteration i (with
    log.log_images)."""
    return (i % 10 == 0 and i < 1000) or i % 100 == 0


def saves_checkpoint(i: int, iterations: int, interval: int) -> bool:
    """A checkpoint (iteration i + 1) and metrics.json after iteration i;
    the last iteration's checkpoint is written after the loop."""
    return interval > 0 and (i + 1) % interval == 0 and (i + 1) < iterations


def make_path(p: Path) -> Path:
    p.mkdir(exist_ok=True, parents=True)
    return p


def _quantize_u8(tensor: torch.Tensor):
    """The device half of image logging: clip and scale to uint8 before the
    copy to the host, and a NaN/Inf flag (uint8 cannot carry them)."""
    t = tensor.float()
    bad = ~torch.isfinite(t).all()
    q = (t.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return q, bad.to(torch.uint8)


def _write_chw_image(path: Path):
    """The writer-thread half of image logging: guard, encode, save a
    (uint8 CHW image, NaN flag) pair from _quantize_u8."""
    def write(packed):
        arr, bad = packed
        if int(bad):
            raise ValueError(
                f"Tensor contains NaNs or infinite values ({path})")
        arr = np.asarray(arr).transpose(1, 2, 0)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        save_image(arr, path)
    return write


class ConTEXTure:
    """Text -> textured mesh: the port's counterpart of
    contexture_nerf_tpu/training/trainer.py `ConTEXTure`. The models come
    from `build_models` (random towers from optim.seed unless given,
    overwritten by the config's local snapshots);
    `paint` runs `paint_zero123plus`: prepare_sds, the SDS loop with its
    metrics, images and checkpoints, then `full_eval` (the turntable and
    the exported mesh). Outputs go to log.exp_root/log.exp_name. On several
    ranks each builds the same run, the step and the eval run over
    `make_mesh`'s mesh, and only rank 0 (`writer`) writes files and logs;
    a resume loads on every rank."""

    # eval frames holding device buffers at once in evaluate()
    _EVAL_INFLIGHT = 3

    def __init__(self, cfg: TrainConfig, tiny_models: bool = False,
                 device="cuda", teacher: Optional[Zero123PlusTeacher] = None,
                 mlp: Optional[NeRF2D] = None,
                 diffusion: Optional[StableDiffusionDepth] = None):
        self.cfg = cfg
        self.mesh = make_mesh(cfg)
        self.writer = pmesh.is_writer()
        self.device = resolve_device(device)
        self.paint_step = 0
        self.tiny = tiny_models

        mk = make_path if self.writer else Path
        self.exp_path = mk(Path(cfg.log.exp_dir))
        self.ckpt_path = mk(self.exp_path / "checkpoints")
        self.train_renders_path = mk(self.exp_path / "vis" / "train")
        self.eval_renders_path = mk(self.exp_path / "vis" / "eval")
        self.final_renders_path = mk(self.exp_path / "results")
        self._init_logger()
        if self.writer:
            dump_config(cfg, self.exp_path / "config.yaml")

        (self.generator, self.teacher, self.mlp, self.diffusion,
         self.mesh_model) = build_models(cfg, tiny_models, self.device,
                                         teacher, mlp, diffusion)
        n = sum(p.numel() for p in self.mlp.parameters())
        logger.info(f"Loaded Mesh, #parameters: {n}")
        self.dataloaders = self._init_dataloaders()
        self.sds: Optional[SDSTrainer] = None
        self.text_z = None
        self._consistency = None
        self._median_eval = False
        self._img_writer = (AsyncImageWriter() if cfg.log.async_image_writer
                            else sync_writer())
        change = self.mesh_model.edit_change_mask
        if change is not None:
            self.log_train_image(change[:, None].repeat(1, 3, 1, 1),
                                 "reference_texture_change_mask",
                                 file_type="png")
        # optional wandb: metrics.json is always written, wandb is opt-in
        self._wandb = None
        if self.writer and os.environ.get("WANDB_ENABLED"):
            try:
                import wandb

                self._wandb = wandb.init(project="ConTEXTure-NeRF-TPU",
                                         config=dict(exp=cfg.log.exp_name))
            except Exception as e:  # a logging sink must not stop the run
                logger.warning(f"wandb disabled: {e!r}")

    # -- setup ----------------------------------------------------------------

    def _init_logger(self):
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(message)s")
        # the module logger is shared: drop the file handlers of earlier
        # runs in this process, or their log.txt would get this run's lines
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                logger.removeHandler(h)
                h.close()
        if not self.writer:  # rank 0 logs for the run
            logger.setLevel(logging.WARNING)
            return
        logger.addHandler(logging.FileHandler(self.exp_path / "log.txt"))
        # log.txt gets the run's INFO lines whatever the root logger's level
        logger.setLevel(logging.INFO)

    def _init_dataloaders(self) -> Dict:
        render = self.cfg.render
        train = (Zero123PlusDataset(render) if self.cfg.guide.use_zero123plus
                 else MultiviewDataset(render))
        return {"train": train,
                "val": ViewsDataset(render, size=self.cfg.log.eval_size),
                "val_large": ViewsDataset(render,
                                          size=self.cfg.log.full_eval_size)}

    # -- main -----------------------------------------------------------------

    def paint(self):
        if not self.cfg.guide.use_zero123plus:
            raise ValueError(
                "guide.use_zero123plus=False has no live paint path (the "
                "reference's paint() also runs the Zero123++ SDS loop "
                "unconditionally, reference trainer.py:367); set it to "
                "true, or use StableDiffusionDepth.img2img_step/sds_grad "
                "directly for single-view guidance")
        self.paint_zero123plus()

    def paint_zero123plus(self):
        """prepare_sds, then optim.sds_iterations SDS steps over the
        DreamTime t schedule: a metric entry every 50 iterations and at the
        last (view_consistency every 250 and at the last), images at the
        reference's cadence, a checkpoint and metrics.json every
        optim.checkpoint_interval; then metrics.json, the final checkpoint,
        full_eval with the median fill, and timings.json. optim.resume
        continues from the newest checkpoint."""
        logger.info("Starting SDS Texture Generation ^_^")
        cfg = self.cfg
        mesh = make_mesh(cfg)
        self.paint_step += 1  # prepare_sds paints the front view
        logger.info(f"--- Painting step #{self.paint_step} ---")
        setup = prepare_sds(cfg, self.mesh_model, self.mlp, self.teacher,
                            generator=self.generator,
                            diffusion=self.diffusion)
        sds = self.sds = make_sds_trainer(
            cfg, setup, teacher=self.teacher, mlp=self.mlp, tiny=self.tiny,
            device=self.device, generator=self.generator,
            mesh_model=self.mesh_model, mesh=mesh)
        iterations = cfg.optim.sds_iterations
        ts = [int(t) for t in sds.t_schedule(iterations).tolist()]

        # params, Adam state, generator state and iteration
        start_iter = 0
        if cfg.optim.resume:
            latest = ckpt.latest_iteration(self.ckpt_path)
            if latest is not None:
                restored = self._restore_checkpoint(latest, sds.optimizer)
                start_iter = int(restored["iteration"])
                logger.info(f"Resumed from checkpoint iter {start_iter}")

        metrics_log: List[Dict] = []
        metrics_path = self.exp_path / "metrics.json"
        if start_iter > 0 and metrics_path.exists():
            # keep the metric history from before the interruption
            try:
                prev = json.loads(metrics_path.read_text())
                metrics_log = [m for m in prev if m["iter"] < start_iter]
            except (json.JSONDecodeError, KeyError):
                pass
        ikl_running_avg = None
        t0 = time.time()
        win_t0, win_i0 = None, start_iter
        for i in range(start_iter, iterations):
            with profiler.phase("sds_step"):
                _, loss, grad_norm, fisher, grid = sds.step(ts[i])
            if self.writer and logs_metrics(i, iterations):
                loss_f = profiler.host_read(loss, "loss")
                # the loss's read waited for the card: note the sync-to-sync
                # window, so timings.json has the device-inclusive rate
                if win_t0 is not None and i > win_i0:
                    profiler.GLOBAL_TIMINGS.note_window(
                        "sds_step", i - win_i0, time.time() - win_t0)
                fisher_f = profiler.host_read(fisher, "fisher")
                grad_norm_f = profiler.host_read(grad_norm, "grad_norm")
                ikl_running_avg = (fisher_f if ikl_running_avg is None
                                   else 0.99 * ikl_running_avg
                                   + 0.01 * fisher_f)
                entry = {"iter": i, "sds_loss": loss_f,
                         "grad_norm": grad_norm_f,
                         "fisher_divergence_t": fisher_f,
                         "ikl_running_avg": ikl_running_avg,
                         "t": ts[i], "elapsed_s": time.time() - t0}
                if logs_view_consistency(i, iterations):
                    with profiler.phase("view_consistency_metric"):
                        entry["view_consistency"] = profiler.host_read(
                            self._view_consistency_metric(),
                            "view_consistency")
                metrics_log.append(entry)
                logger.info(f"iter {i}: sds_loss={loss_f:.4f} t={ts[i]} "
                            f"grad_norm={grad_norm_f:.4g}")
                if self._wandb is not None:
                    self._wandb.log(metrics_log[-1])
                # the window restarts after the metric work, so
                # window_iter_ms counts loop iterations only
                win_t0, win_i0 = time.time(), i
            if self.writer and cfg.log.log_images and logs_images(i):
                self.log_texture_map(i)
                self.log_train_image(sds.canvas_rgb(grid),
                                     f"rendered_grid_clean_{i}")
            if self.writer and saves_checkpoint(
                    i, iterations, cfg.optim.checkpoint_interval):
                self.save_checkpoint(i + 1, sds.optimizer)
                # metrics survive a real interruption too
                metrics_path.write_text(json.dumps(metrics_log, indent=1))

        if self.writer:
            metrics_path.write_text(json.dumps(metrics_log, indent=1))
            self.save_checkpoint(iterations, sds.optimizer)
        self._median_eval = True
        logger.info("Finished SDS Painting ^_^")
        self.full_eval()
        self._img_writer.flush()  # raise any failed or pending log write
        if self.writer:
            profiler.GLOBAL_TIMINGS.dump(self.exp_path / "timings.json")

    @torch.no_grad()
    def paint_viewpoint(self, data: Dict, should_project_back: bool = False,
                        draws: Optional[Dict[str, torch.Tensor]] = None,
                        timings: Optional[Dict[str, float]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The next paint step of the pose `data` (theta, phi, radius): the
        free `paint_viewpoint` at paint_step + 1, so a repaint pass renders
        with the median fill and, with guide.use_inpainting, inpaints. Logs
        the render, the output and the diffusion steps (with
        log.vis_diffusion_steps). should_project_back is dead, as in the
        reference (its consumer does not exist there). Returns (rgb
        (1,3,H,W), object mask (1,1,H,W))."""
        if self.diffusion is None:
            raise ValueError("paint_viewpoint needs the SD2-depth stack")
        self.paint_step += 1
        logger.info(f"--- Painting step #{self.paint_step} ---")
        logger.info(f"Painting from theta: {data['theta']}, phi: "
                    f"{self._adjust_phi(data['phi'])}, radius: "
                    f"{data['radius']}")
        if self.text_z is None:
            self.text_z, _ = calc_text_embeddings(self.cfg, self.diffusion)
        start = time.perf_counter()
        rgb_output, object_mask, rgb_render, steps_vis = paint_viewpoint(
            self.cfg, self.mesh_model, self.mlp, self.diffusion, self.text_z,
            draws=draws, timings=timings, paint_step=self.paint_step,
            pose=data)
        self.log_train_image(rgb_render, "paint_viewpoint:rgb_render")
        logger.info(f"img2img elapsed: {time.perf_counter() - start:.2f}s")
        self.log_diffusion_steps(steps_vis)
        self.log_train_image(rgb_output, "full_output")
        return rgb_output, object_mask

    @torch.no_grad()
    def _view_consistency_metric(self) -> torch.Tensor:
        """The cross-view consistency of the current texture: the 6 target
        views' geometry at min(192, train_grid_size)^2, rendered once and
        cached (K5 on the card), the MLP queried at their UVs (K1),
        composited on 0.5 grey, then `compute_view_consistency`."""
        model = self.mesh_model
        if self._consistency is None:
            dims = min(192, self.cfg.render.train_grid_size)
            thetas, phis, radii = view_angles(self.cfg.render)
            cache = model.render_geometry(thetas[1:], phis[1:], radii[1:],
                                          dims=(dims, dims))
            self._consistency = (cache, int(model.faces.max()) + 1)
        cache, n_verts = self._consistency
        V, H, W = cache.face_idx.shape
        rgb = model.query_texture_at_uv(self.mlp,
                                        cache.uv_features.reshape(-1, 2))
        imgs = rgb.reshape(V, H, W, 3).permute(0, 3, 1, 2)
        imgs = imgs * cache.mask + 0.5 * (1 - cache.mask)
        return compute_view_consistency(imgs, model.faces, cache.face_idx,
                                        cache.face_vertices_image,
                                        n_vertices=n_verts)

    # -- eval ---------------------------------------------------------------------

    def _adjust_phi(self, phi) -> float:
        phi = phi - np.deg2rad(self.cfg.render.front_offset)
        return float(phi + 2 * np.pi if phi < 0 else phi)

    def _eval_texture(self) -> torch.Tensor:
        """The texture map of the eval renders (1,3,R,R) (K1 on the card),
        median-filled after painting. It depends on the parameters only, so
        `evaluate` computes it once for all its frames."""
        texture, _ = self.mesh_model.get_texture_map(self.mlp)
        if self._median_eval:
            texture = self.mesh_model.apply_median_fill(texture)
        return texture

    @torch.no_grad()
    def eval_render(self, data):
        """One eval render of a pose dict: (rgb, texture, depth, z_normals)
        as the reference's eval graph returns them."""
        texture = self._eval_texture()
        rgb, depth, z = eval_frame(
            self.mesh_model, texture, [data["theta"]],
            [self._adjust_phi(data["phi"])], [data["radius"]],
            self.cfg.render.eval_grid_size)
        return rgb, texture.permute(0, 2, 3, 1).clamp(0, 1), depth, z

    @torch.no_grad()
    def evaluate(self, dataloader, save_path: Path,
                 save_as_video: bool = False, mesh="config"):
        """Render every pose of `dataloader` at render.eval_grid_size and
        write the frames (a turntable video with save_as_video, else one JPG
        each) and eval_texture_atlas.png. Each frame is quantised on the
        card and copied to the host while the next renders, with at most
        _EVAL_INFLIGHT frames holding device buffers; a non-finite frame
        raises. Notes the "eval" window (frames after the first). Under a
        mesh the poses go in chunks of the `views` size, the last pose
        repeated to fill the last chunk: each rank renders its pose of a
        chunk, the chunk's frames are all-gathered, and rank 0 writes the
        real ones. `mesh` is make_mesh(cfg) by default."""
        mesh = make_mesh(self.cfg) if mesh == "config" else mesh
        logger.info(f"Evaluating and saving model, painting iteration "
                    f"#{self.paint_step}...")
        if self.writer:
            save_path.mkdir(exist_ok=True, parents=True)
        dim = self.cfg.render.eval_grid_size
        poses = list(dataloader)
        n_real = len(poses)
        chunk = pmesh.axis_size(mesh, "views")
        poses += poses[-1:] * ((-n_real) % chunk)
        vr = pmesh.axis_rank(mesh, "views")
        texture = self._eval_texture()
        all_preds = []
        pending = deque()
        win = {"t_first": None, "frames": 0}

        def drain_one():
            i, get_q, get_bad = pending.popleft()
            if int(get_bad()):
                raise ValueError("Tensor contains NaNs or infinite values "
                                 f"(eval frame {i})")
            arr = get_q()
            if win["t_first"] is None:
                win["t_first"] = time.perf_counter()
            else:
                win["frames"] += 1
            if save_as_video:
                all_preds.append(arr[0])
            else:
                save_image(arr[0], save_path / f"eval_rendered_{i:04d}_rgb.jpg")

        for c in range(0, len(poses), chunk):
            p = poses[c + vr]
            rgb, _, _ = eval_frame(self.mesh_model, texture, [p["theta"]],
                                   [self._adjust_phi(p["phi"])],
                                   [p["radius"]], dim)
            q, bad = _quantize_u8(rgb)
            if mesh is not None:
                group = mesh.get_group("views")
                q = pmesh.all_gather_cat(q, group)
                bad = pmesh.all_gather_cat(bad[None], group)
            if not self.writer:
                continue
            for j in range(min(chunk, n_real - c)):
                pending.append((c + j, start_host_copy(q[j:j + 1]),
                                start_host_copy(bad.reshape(-1)[j])))
                if len(pending) >= self._EVAL_INFLIGHT:
                    drain_one()
        while pending:
            drain_one()
        if not self.writer:
            return
        if win["t_first"] is not None and win["frames"] > 0:
            profiler.GLOBAL_TIMINGS.note_window(
                "eval", win["frames"], time.perf_counter() - win["t_first"])
        atlas = texture.permute(0, 2, 3, 1).clamp(0, 1)[0]
        save_image(tensor2numpy(atlas), save_path / "eval_texture_atlas.png")
        if save_as_video and all_preds:
            stacked = np.stack(all_preds, axis=0)
            base = save_path / \
                f"eval_video_all_rendered_rgb_{self.cfg.optim.seed}"
            try:
                import imageio

                imageio.mimsave(base.with_suffix(".mp4"), stacked, fps=25,
                                quality=8, macro_block_size=1)
            except (ImportError, ValueError):
                # no imageio or no ffmpeg backend: a GIF
                save_gif(stacked, base.with_suffix(".gif"), fps=25)
        logger.info("Eval Done!")

    def full_eval(self, output_dir: Optional[Path] = None):
        output_dir = output_dir or self.final_renders_path
        self._img_writer.flush()  # the loop's log writes land before eval's
        with profiler.phase("eval"):
            self.evaluate(self.dataloaders["val_large"], output_dir,
                          save_as_video=True)
        if self.cfg.log.save_mesh and self.writer:
            save_path = make_path(self.exp_path / "mesh")
            logger.info(f"Saving mesh to {save_path}")
            with profiler.phase("export"):
                self.mesh_model.export_mesh(save_path, self.mlp)
            logger.info("\t Full Eval Done!")

    # -- checkpoints ----------------------------------------------------------------

    def save_checkpoint(self, iteration: int,
                        optimizer: Optional[torch.optim.Optimizer] = None):
        """The MLP's parameters, the optimizer's state, the generator's
        state and the iteration, so that a resumed run is bit-identical to
        an uninterrupted one."""
        ckpt.save(self.ckpt_path / f"iter_{iteration:06d}",
                  self.mlp.state_dict(),
                  opt_state=(optimizer.state_dict() if optimizer is not None
                             else None),
                  iteration=iteration,
                  generator_state=self.generator.get_state())

    def _restore_checkpoint(self, iteration: int,
                            optimizer: Optional[torch.optim.Optimizer] = None
                            ) -> Dict:
        """Load a checkpoint into the MLP, the optimizer and the generator.
        One of the older format (params and iteration only) restores the
        parameters alone."""
        raw = ckpt.restore(self.ckpt_path / f"iter_{iteration:06d}")
        self.mlp.load_state_dict(raw["params"])
        if optimizer is not None and raw.get("opt_state") is not None:
            optimizer.load_state_dict(raw["opt_state"])
        if raw.get("generator") is not None:
            self.generator.set_state(raw["generator"])
        return raw

    def load_checkpoint(self, iteration: int) -> Dict:
        raw = ckpt.restore(self.ckpt_path / f"iter_{iteration:06d}")
        self.mlp.load_state_dict(raw["params"])
        return raw

    # -- logging ----------------------------------------------------------------------

    def log_train_image(self, tensor: torch.Tensor, name: str,
                        file_type: str = "jpg", colormap: bool = False):
        """vis/train/debug_<name>.<file_type> from the first image of a
        batch; colormap routes a (H,W) scalar map through the seismic
        colormap. Quantised here, written on the writer thread (rank 0
        only)."""
        if not self.cfg.log.log_images or not self.writer:
            return
        path = self.train_renders_path / f"debug_{name}.{file_type}"
        if colormap:
            self._img_writer.submit(tensor,
                                    lambda arr: save_colormap(arr, path))
            return
        self._img_writer.submit(_quantize_u8(tensor[0]),
                                _write_chw_image(path))

    def log_diffusion_steps(self, intermediate_vis):
        """The intermediate denoise frames, in a folder per paint step (rank
        0 only)."""
        if not intermediate_vis or not self.writer:
            return
        folder = (self.train_renders_path
                  / f"{self.paint_step:04d}_diffusion_steps")
        folder.mkdir(exist_ok=True, parents=True)
        for k, frame in enumerate(intermediate_vis):
            self._img_writer.submit(
                _quantize_u8(frame[0]),
                _write_chw_image(folder / f"{k:02d}_diffusion_step.jpg"))

    @torch.no_grad()
    def log_texture_map(self, iteration: int):
        """vis/train/texture_map_iter_<iteration>.png: the texture lattice
        (K1 on the card), quantised on the card."""
        texture, _ = self.mesh_model.get_texture_map(self.mlp)
        self._img_writer.submit(
            _quantize_u8(texture[0]), _write_chw_image(
                self.train_renders_path
                / f"texture_map_iter_{iteration:06d}.png"))
