"""The SDS loop over a video teacher's orbit: guide.teacher "sv3d_p".

`prepare_orbit_sds` is `prepare_sds` for SV3D_p: K5 rasterizes the 21
orbit views (views_dataset.OrbitDataset) at render.train_grid_size in one
launch; each view is cropped to its object box and resized to the
teacher's 576^2 frame (the mask-weighted UVs and the mask, as the Zero123++
path does its six tiles to 320^2); the front image (the bootstrap's repaint
of the front pose, or its current render with skip_bootstrap) is cut out
the same way on white and conditioned once (the CLIP image tower, the VAE
mode after cond_aug); the frames' sampling probabilities come from the
masks and view weights as the tiles' do.

`OrbitSDSTrainer` runs `SDSTrainer.step` with the frames on the batch
axis: K1 over the 21 frames' precomputed Fourier embedding (7.0 M points
at full size), the composite on white, the VAE encode of the batch of 21
(no gradient), then K1, composite and encode again for one sampled frame
with the gradient, grafted into its latent as a zero-valued delta (the
local_sds_grad form); one teacher call at batch 2 x 21; the SDS target of
every frame and the 1/2-sum-square loss of the sampled frame; the backward
through that frame's render and encode; Adam. Its draws are the frame
index (the step's one host read), the posterior's eps and the noise of the
21 latents. The view layout is fixed when the trainer is built.

One rank only: a device mesh, optim.exact_lattice_render and the
Zero123++ knobs (tile's individual CFG) do not apply here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import phase
from contexture_nerf_tpu_torch.core import profiler
from contexture_nerf_tpu_torch.diffusion import schedulers as sch
from contexture_nerf_tpu_torch.diffusion.sv3d import SV3DTeacher
from contexture_nerf_tpu_torch.diffusion.vae import encode_moments
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.models.textured_mesh import TexturedMeshModel
from contexture_nerf_tpu_torch.ops.image import (crop_and_resize,
                                                 get_nonzero_region_tuple)
from contexture_nerf_tpu_torch.ops.mlp_kernel import (fused_nerf2d,
                                                      fused_nerf2d_emb,
                                                      pad_embedding)
from contexture_nerf_tpu_torch.ops.view_weights import compute_view_weights
from contexture_nerf_tpu_torch.training import trainer as tr
from contexture_nerf_tpu_torch.training.views_dataset import (
    OrbitDataset, Zero123PlusDataset)

WHITE = 1.0


def orbit_views(render, frames: int, elevation_deg: float
                ) -> Tuple[List[float], List[float], List[float]]:
    """(thetas, phis, radii) of the orbit, phi shifted by
    render.front_offset as the fixed views' are."""
    poses = OrbitDataset(render, frames, elevation_deg).poses()
    off = np.deg2rad(render.front_offset)
    return ([p["theta"] for p in poses],
            [(p["phi"] - off) % (2 * np.pi) for p in poses],
            [p["radius"] for p in poses])


@torch.no_grad()
def prepare_orbit_sds(cfg, mesh_model: TexturedMeshModel, mlp: NeRF2D,
                      teacher: SV3DTeacher,
                      eps_aug: Optional[torch.Tensor] = None,
                      skip_bootstrap: bool = False,
                      generator: Optional[torch.Generator] = None,
                      timings: Optional[Dict[str, float]] = None,
                      diffusion=None,
                      bootstrap_draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict:
    """The orbit's static setup for `OrbitSDSTrainer`. `eps_aug` (1, 3,
    P, P) is the normal draw of the condition image's noise augmentation,
    drawn from `generator` when None. `timings` receives geometry, the
    bootstrap's phases (or render), crops and conditioning.

    Returns mask_frames (T,1,P,P), uv_frame_pts (T P^2, 2), edit_mask_pts
    (T P^2, 1) or None, cond_image (1,3,P,P) in [0,1], z_cond (1,4,P/8,P/8),
    context (1,1,ctx), frame_probs (T,), bboxes (the views' crop boxes)
    and front_rgb."""
    if not skip_bootstrap and diffusion is None:
        raise ValueError("the bootstrap (skip_bootstrap=False) needs the "
                         "SD2-depth stack: pass diffusion=StableDiffusionDepth"
                         "(...)")
    if cfg.optim.exact_lattice_render:
        raise ValueError("optim.exact_lattice_render renders the Zero123++ "
                         "grid; guide.teacher 'sv3d_p' has no such path")
    dev = mesh_model.device
    P, T = teacher.frame_px, teacher.frames
    if eps_aug is None:
        g = generator or torch.Generator(device=dev).manual_seed(
            cfg.optim.seed)
        eps_aug = torch.randn((1, 3, P, P), generator=g, device=g.device)
    with phase(timings, "geometry", dev):
        thetas, phis, radii = orbit_views(cfg.render, T, teacher.elevation_deg)
        cache = mesh_model.render_geometry(theta=thetas, phi=phis,
                                           radius=radii)
        view_weights = compute_view_weights(cache.face_idx[:, None],
                                            cache.face_normals[..., 2])
    if skip_bootstrap:
        with phase(timings, "render", dev):
            pose = Zero123PlusDataset(cfg.render).poses()[0]
            phi = (pose["phi"] - np.deg2rad(cfg.render.front_offset)) % (
                2 * np.pi)
            out = mesh_model.render(
                mlp, theta=[pose["theta"]], phi=[float(phi)],
                radius=[pose["radius"]],
                background=torch.full((3,), WHITE, device=dev))
            rgb_front, mask_front = out["image"], out["mask"]
    else:
        with phase(timings, "bootstrap_text", dev):
            text_z, _ = tr.calc_text_embeddings(cfg, diffusion)
        rgb_front, mask_front, _, _ = tr.paint_viewpoint(
            cfg, mesh_model, mlp, diffusion, text_z, draws=bootstrap_draws,
            timings=timings)
    with phase(timings, "crops", dev):
        masks = cache.mask
        bboxes = [get_nonzero_region_tuple(m)
                  for m in masks[:, 0].cpu().numpy()]
        box = get_nonzero_region_tuple(mask_front[0, 0])
        a = crop_and_resize(mask_front, box, P, P)
        cond_image = crop_and_resize(rgb_front, box, P, P) * a + WHITE * (1 - a)
        uv_maps = cache.uv_features.permute(0, 3, 1, 2)
        uv_t, m_t = [], []
        for i, b in enumerate(bboxes):
            m = masks[i:i + 1]
            mt = crop_and_resize(m, b, P, P)
            uv_t.append(crop_and_resize(uv_maps[i:i + 1] * m, b, P, P)
                        / mt.clamp(min=1e-6))
            m_t.append(mt)
        uv_pts = torch.cat(uv_t).permute(0, 2, 3, 1).reshape(-1, 2).clamp(
            0.0, 1.0).contiguous()
        edit_pts = None
        change = mesh_model.edit_change_mask
        if change is not None:
            res = change.shape[-1]
            edit_pts = tr.map_coordinates_linear(
                change[0].to(dev), uv_pts[:, 1] * (res - 1),
                uv_pts[:, 0] * (res - 1))[:, None]
    with phase(timings, "conditioning", dev):
        z_cond, context = teacher.encode_condition(cond_image * 2 - 1,
                                                   eps_aug.to(dev))
    probs = tr.view_probabilities(masks, view_weights,
                                  cfg.optim.tile_weighting)
    return {"mask_frames": torch.cat(m_t), "uv_frame_pts": uv_pts,
            "edit_mask_pts": edit_pts, "cond_image": cond_image,
            "z_cond": z_cond, "context": context,
            "frame_probs": probs.to(dev), "bboxes": bboxes,
            "front_rgb": rgb_front}


class OrbitSDSTrainer(tr.SDSTrainer):
    """`SDSTrainer` over SV3D_p's orbit (module docstring). `setup` is
    `prepare_orbit_sds`'s; the step is the base class's."""

    def __init__(self, cfg, setup: Dict, teacher: Optional[SV3DTeacher] = None,
                 mlp: Optional[NeRF2D] = None, tiny: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 mesh_model: Optional[TexturedMeshModel] = None,
                 mesh="config"):
        if cfg.optim.exact_lattice_render:
            raise ValueError("optim.exact_lattice_render renders the "
                             "Zero123++ grid; guide.teacher 'sv3d_p' has "
                             "no such path")
        self._init_common(cfg, SV3DTeacher, teacher, mlp, tiny, device,
                          generator, mesh_model, mesh)
        if self.mesh is not None:
            raise ValueError("guide.teacher 'sv3d_p' runs on one rank: "
                             "optim.data_parallel has no orbit path")
        dev = self.device
        self.frames = self.teacher.frames
        self.frame_px = self.teacher.frame_px
        self.lat_px = self.frame_px // self.vae_down
        self.guidance = self.teacher.guidance
        self.local_grad = True
        self.mask_frames = tr._to(setup["mask_frames"], dev, torch.float32)
        self.uv_pts = tr._to(setup["uv_frame_pts"], dev,
                             torch.float32).contiguous()
        self.emb_pts = (pad_embedding(self.uv_pts, tr.MULTIRES,
                                      dtype=self.mlp_dtype)
                        if cfg.optim.precompute_uv_embedding else None)
        self.edit_mask = tr._to(setup.get("edit_mask_pts"), dev,
                                torch.float32)
        self.z_cond = tr._to(setup["z_cond"], dev, self.dtype)
        self.context = tr._to(setup["context"], dev, self.dtype)
        self.tile_probs = tr._to(setup["frame_probs"], dev, torch.float32)

    # -- student render ------------------------------------------------------

    def _query(self, frame: Optional[int] = None):
        """Texture colours in [0, 1] at the frames' UVs, or at one frame's."""
        src = self.emb_pts if self.emb_pts is not None else self.uv_pts
        m = self.edit_mask
        if frame is not None:
            n = self.frame_px * self.frame_px
            src = src[frame * n:(frame + 1) * n]
            m = m[frame * n:(frame + 1) * n] if m is not None else None
        fn = fused_nerf2d_emb if self.emb_pts is not None else fused_nerf2d
        out = fn(self.mlp, src, tr.MULTIRES, compute_dtype=self.mlp_dtype)
        rgb = (torch.tanh(out) + 1.0) / 2.0
        if m is not None:
            rgb = m * rgb + (1 - m) * rgb.detach()
        return rgb

    def _frames(self, rgb, mask):
        """(n P^2, 3) colours -> (n, 3, P, P) in [-1, 1] on white."""
        P = self.frame_px
        img = rgb.reshape(-1, P, P, 3).permute(0, 3, 1, 2).contiguous()
        img = torch.clamp(img * mask + WHITE * (1 - mask), 0.0, 1.0)
        return img * 2 - 1

    def _encode(self, img, eps):
        mean, logvar = encode_moments(self.teacher.vae_encoder, img)
        return (mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)) * \
            self.teacher.vae_config.scaling_factor

    def render_grid_latent(self, eps):
        """All frames: MLP -> composite -> VAE encode. Returns (z (T, 4,
        h, w), frames (T, 3, P, P), rgb)."""
        with profiler.span("sds.render"):
            rgb = self._query()
            frames = self._frames(rgb, self.mask_frames)
        with profiler.span("sds.encode"):
            return self._encode(frames, eps), frames, rgb

    def render_grid_latent_local(self, eps, tile_idx: int):
        """The frames forward only; the gradient flows through the sampled
        frame's render and encode, grafted into its latent as a
        zero-valued delta."""
        with torch.no_grad():
            z_full, frames, rgb = self.render_grid_latent(eps)
        f = tile_idx
        with profiler.span("sds.render"):
            patch = self._frames(self._query(f), self.mask_frames[f:f + 1])
        with profiler.span("sds.encode"):
            z_f = self._encode(patch, eps[f:f + 1])
            z = z_full.clone()
            z[f:f + 1] = z_full[f:f + 1] + (z_f - z_f.detach()).to(
                z_full.dtype)
        return z, frames, rgb

    def canvas_rgb(self, grid):
        return (grid + 1) / 2

    # -- the step --------------------------------------------------------------

    def latent_shape(self):
        return (self.frames, 4, self.lat_px, self.lat_px)

    def draw(self) -> Dict[str, torch.Tensor]:
        g, dev = self.generator, self.device
        shape = self.latent_shape()
        return {
            "tile_idx": torch.multinomial(self.tile_probs, 1, generator=g),
            "eps": torch.randn(shape, generator=g, device=dev).to(self.dtype),
            "noise": torch.randn(shape, generator=g, device=dev)}

    def _teacher(self, z_sg, noise, t_t, neg_noise, cond_noise):
        latents_noisy = sch.add_noise(self.acp, z_sg, noise, t_t)
        return self.teacher.teacher_v_pred(latents_noisy, t_t, self.z_cond,
                                           self.context, self.guidance)

    def _sampled(self, x, frame: int):
        return x[frame]

    def _sds_loss(self, z, targets, tile_idx: int):
        """1/2 sum of squares over the sampled frame."""
        return 0.5 * torch.sum((self._sampled(z, tile_idx)
                                - self._sampled(targets, tile_idx)) ** 2)
