"""Texture renders: paint a survey of mesh x prompt pairs, then write the 7
canonical Zero123++ views of each as uniform 320x320 crops; the
counterpart of get_texture_renders_cond_grid.py.

    python -m contexture_nerf_tpu_torch.get_texture_renders_cond_grid \
        [--out_root experiments/texture_renders]

For each pair: `ConTEXTure.paint` (guidance scale 10, Zero123++ teacher,
learn_max_z_normals, the pair's front offset), or `full_eval` when the
config asks for log.eval_only; then the 7 canonical poses (theta by phi
as canonical_theta gives it, radius 1.5) rendered on 0.5 grey,
composited on white, each cropped to its object's square box, padded to
the largest crop of the 7 with white and resized to 320x320, written as
<out_root>/<mesh>/<exp_name>/rendered_image_<i>.png. A mesh that is
missing takes its procedural stand-in (tools/make_shapes.py) where there
is one; a pair that raises is tried again, up to MAX_RETRIES times.
"""

from __future__ import annotations

import argparse
import math
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.ops.image import (get_nonzero_region_tuple,
                                                 pad_tensor_to_size,
                                                 resize_bilinear, save_image,
                                                 tensor2numpy)
from contexture_nerf_tpu_torch.tools.make_shapes import ensure_shape
from contexture_nerf_tpu_torch.training.trainer import ConTEXTure

PAIRS = [
    {
        "prompts": [
            "a photo of spiderman",
            "a caricature of a pirate with a large hat and eye patch",
            "a whimsical wizard with a pointed hat, dark shadow",
            "a cartoon astronaut with a bubbly space helmet",
        ],
        "path": "shapes/human.obj",
    },
    {
        "prompts": [
            "white humanoid robot, movie poster, main character of a "
            "science fiction movie",
            "comic book superhero, red body suit",
        ],
        "path": "shapes/human.obj",
        "front_offset": -90.0,
    },
]

CANONICAL_PHIS = [0, 30, 90, 150, 210, 270, 330]  # the 7 Zero123++ poses
MAX_RETRIES = 3
CROP = 320


def canonical_theta(phi_deg: float) -> float:
    if phi_deg in (30, 150, 270):
        return math.radians(90 - 30)
    if phi_deg in (90, 210, 330):
        return math.radians(90 + 20)
    return math.radians(60)


def run_one(pair: Dict, prompt: str, out_root: Path,
            overrides: Optional[Dict[str, dict]] = None, device="cuda",
            tiny_models: bool = False, **models
            ) -> Tuple[ConTEXTure, List[Path]]:
    """Paint one pair and write its 7 canonical crops. `overrides`
    ({section: {key: value}}) go over the pair's config; `models`
    (teacher, mlp, diffusion) go to ConTEXTure in place of new random
    ones. Returns (the run, the files written)."""
    exp_name = f"{Path(pair['path']).stem}_" + "".join(
        c for c in prompt if c.isalnum() or c == " ").replace(" ", "_")[:40]
    data = {
        "log": {"exp_name": exp_name},
        "guide": {"text": prompt, "shape_path": pair["path"],
                  "guidance_scale": 10, "use_zero123plus": True},
        "optim": {"learn_max_z_normals": True},
    }
    if "front_offset" in pair:
        data["render"] = {"front_offset": pair["front_offset"]}
    for section, values in (overrides or {}).items():
        data.setdefault(section, {}).update(values)
    cfg = config_from_dict(data)
    trainer = ConTEXTure(cfg, tiny_models=tiny_models, device=device,
                         **models)
    if cfg.log.eval_only:
        trainer.full_eval()
    else:
        trainer.paint()

    grey = torch.full((3,), 0.5, device=trainer.device)
    crops = []
    for phi in CANONICAL_PHIS:
        out = trainer.mesh_model.render(
            trainer.mlp, theta=canonical_theta(phi), phi=math.radians(phi),
            radius=1.5, background=grey)
        rgba = out["image"] * out["mask"] + (1.0 - out["mask"])
        mh, mw, Mh, Mw = get_nonzero_region_tuple(out["mask"][0, 0])
        crops.append(rgba[:, :, mh:Mh, mw:Mw])
    max_h = max(c.shape[-2] for c in crops)
    max_w = max(c.shape[-1] for c in crops)

    out_dir = Path(out_root) / Path(pair["path"]).stem / exp_name
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, crop in enumerate(crops):
        tile = resize_bilinear(pad_tensor_to_size(crop, max_h, max_w),
                               CROP, CROP)
        written.append(save_image(tensor2numpy(tile[0].permute(1, 2, 0)),
                                  out_dir / f"rendered_image_{i}.png"))
    print(f"wrote 7 canonical renders to {out_dir}")
    return trainer, written


def main(argv: Optional[List[str]] = None, device="cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_root", default="experiments/texture_renders")
    args = ap.parse_args(argv)
    for pair in PAIRS:
        if not ensure_shape(pair["path"]):
            print(f"skip {pair['path']}: mesh missing, no stand-in")
            continue
        for prompt in pair["prompts"]:
            for attempt in range(MAX_RETRIES):
                try:
                    run_one(pair, prompt, Path(args.out_root), device=device)
                    break
                except KeyboardInterrupt:
                    sys.exit(0)
                except Exception:
                    traceback.print_exc()
                    print(f"retry {attempt + 1}/{MAX_RETRIES} for {prompt}")


if __name__ == "__main__":
    main(sys.argv[1:])
