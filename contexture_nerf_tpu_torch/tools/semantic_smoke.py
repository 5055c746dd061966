"""Semantic smoke: the production SDS step paints a sphere the colour the
teacher asks for. Counterpart of tools/semantic_smoke.py.

    python -m contexture_nerf_tpu_torch.tools.semantic_smoke \
        [--iters 200] [--out experiments/semantic_smoke]

Random diffusion weights paint noise, so this swaps in a teacher that is
trained by construction: its v-prediction is exactly the velocity that
points at a fixed target latent, the encoding of a solid red render
(`target_v_pred`). A random tiny VAE encoder is not injective, so pulling
the latents toward the target would not pull the pixels toward red; the
VAE encoder is swapped for `FaithfulCodec`, which is exactly invertible on
solid colours. Both are substituted on the teacher object; the step, the
MLP, the render and Adam are the production `SDSTrainer`'s.

Writes before.png and after.png (the 3x2 student grid after the first and
the last step), albedo_before.png and albedo_after.png (the texture map)
and result.json (mean colours inside the mask, their mean absolute error
from the target), and prints result.json's content as one line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.diffusion.zero123plus import (scale_image,
                                                             scale_latents,
                                                             unscale_image)
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops.image import save_image
from contexture_nerf_tpu_torch.tools.make_shapes import uv_sphere, write_obj
from contexture_nerf_tpu_torch.training.trainer import (ConTEXTure,
                                                        SDSTrainer,
                                                        prepare_sds)

TARGET = (1.0, 0.2, 0.2)  # the colour the smoke's teacher asks for
T_SMOKE = 300  # the fixed timestep of every step


class FaithfulCodec(nn.Module):
    """A VAE encoder stand-in: its moments are the image average-pooled by
    `factor` with channels (r, g, b, luma), linear and injective on images
    constant over each pool window, and logvar -20 (sampling noise about
    e^-10). `decode` upsamples the rgb channels back."""

    def __init__(self, factor: int, dtype=torch.float32):
        super().__init__()
        self.factor, self.dtype = factor, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        f = self.factor
        p = x.reshape(B, C, H // f, f, W // f, f).mean(dim=(3, 5))
        mean = torch.cat([p, p.mean(dim=1, keepdim=True)], dim=1)
        return torch.cat([mean, torch.full_like(mean, -20.0)], dim=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        f = self.factor
        return z[:, :3].repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def target_v_pred(acp: torch.Tensor, z_tgt: torch.Tensor) -> Callable:
    """A teacher `_cfg_v_pred` whose v-prediction at a noised latent is the
    velocity consistent with the clean latent z_tgt."""

    def v_pred(latents_noisy, t, *args, **kwargs):
        a = acp[t].reshape(-1, 1, 1, 1)
        eps = (latents_noisy - torch.sqrt(a) * z_tgt) / torch.sqrt(1 - a)
        return torch.sqrt(a) * eps - torch.sqrt(1 - a) * z_tgt

    return v_pred


def run(out_dir: Path, iters: int = 200, grid_size: int = 64,
        tex_res: int = 32, sds_lr: float = 2e-3, device="cuda",
        mlp: Optional[NeRF2D] = None,
        draws: Optional[Callable[[int], Dict]] = None,
        teacher_rgb: Sequence[float] = TARGET) -> dict:
    """`iters` production SDS steps at t=300 on a tiny ConTEXTure of a
    12x18 UV sphere, its teacher asking for `teacher_rgb` (the result is
    measured against TARGET whatever it asks for). `mlp` replaces the
    seeded texture MLP; `draws(i)` gives step i's draws (SDSTrainer.step's)
    in place of the trainer's generator. Returns result.json's content."""
    out_dir = Path(out_dir)
    tmp = Path(tempfile.mkdtemp(prefix="ctn_smoke_"))
    sphere = tmp / "sphere.obj"
    write_obj(sphere, *uv_sphere(12, 18))
    cfg = config_from_dict({
        "log": {"exp_name": "semantic_smoke", "exp_root": str(tmp / "exp"),
                "eval_size": 1, "full_eval_size": 1, "log_images": False,
                "save_mesh": False},
        "render": {"train_grid_size": grid_size,
                   "eval_grid_size": grid_size},
        "guide": {"text": "smoke", "shape_path": str(sphere),
                  "texture_resolution": tex_res},
        "optim": {"seed": 0, "sds_iterations": 1, "sds_lr": sds_lr},
    })
    run_ = ConTEXTure(cfg, tiny_models=True, device=device, mlp=mlp)
    teacher = run_.teacher
    teacher.vae_encoder = FaithfulCodec(teacher.vae_config.downsample,
                                        teacher.dtype)
    setup = prepare_sds(cfg, run_.mesh_model, run_.mlp, teacher,
                        skip_bootstrap=True, generator=run_.generator)
    mask = torch.as_tensor(setup["mask_grid"], device=run_.device).float()
    rgb = torch.tensor(teacher_rgb, device=mask.device).reshape(1, 3, 1, 1)
    grid = scale_image((rgb * mask + 0.5 * (1 - mask)) * 2 - 1)
    mean = teacher.vae_encoder(grid)[:, :teacher.vae_config.latent_channels]
    z_tgt = scale_latents(mean * teacher.vae_config.scaling_factor)
    teacher._cfg_v_pred = target_v_pred(teacher.alphas_cumprod, z_tgt)
    sds = SDSTrainer(cfg, setup, teacher=teacher, mlp=run_.mlp, tiny=True,
                     device=run_.device, generator=run_.generator,
                     mesh_model=run_.mesh_model)

    out_dir.mkdir(parents=True, exist_ok=True)
    inside = mask[0, 0].cpu().numpy() > 0.5

    def save_grid(g, name):
        img = (unscale_image(g.float()) / 2 + 0.5)[0].permute(1, 2, 0)
        img = np.clip(img.cpu().numpy(), 0, 1)
        save_image((img * 255).astype(np.uint8), out_dir / name)
        return img[inside].mean(axis=0)

    def save_albedo(name):
        with torch.no_grad():
            tex, _ = run_.mesh_model.get_texture_map(sds.mlp)
        tex = np.clip(tex[0].permute(1, 2, 0).float().cpu().numpy(), 0, 1)
        save_image((tex[..., :3] * 255).astype(np.uint8), out_dir / name)

    save_albedo("albedo_before.png")
    color_before = None
    for i in range(iters):
        _, _, _, _, g = sds.step(T_SMOKE, draws(i) if draws else None)
        if i == 0:
            color_before = save_grid(g, "before.png")
    color_after = save_grid(g, "after.png")
    save_albedo("albedo_after.png")

    target = np.array(TARGET)
    res = {
        "iters": iters,
        "color_before": [round(float(c), 4) for c in color_before],
        "color_after": [round(float(c), 4) for c in color_after],
        "target": target.tolist(),
        "err_before": round(float(np.abs(color_before - target).mean()), 4),
        "err_after": round(float(np.abs(color_after - target).mean()), 4),
    }
    (out_dir / "result.json").write_text(json.dumps(res, indent=1))
    return res


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="experiments/semantic_smoke")
    args = ap.parse_args(argv)
    res = run(Path(args.out), args.iters, device=device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
