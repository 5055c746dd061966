"""Survey textures: paint each mesh x prompt pair of the survey, then write
its 7 canonical views as 320x320 crops; the counterpart of
generate_survey_textures.py.

    python -m contexture_nerf_tpu_torch.generate_survey_textures \
        [--out_dir experiments/survey_renders]

For each pair whose mesh exists: `ConTEXTure.paint` at the default config
(log.exp_name survey_<mesh>_<prompt>), then the train dataset's 7 poses
rendered on white, each cropped to its object's square box and resized to
320x320, written as <mesh>_<prompt>_view<i>.png. A pair that raises is
tried again, up to MAX_RETRIES times.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.ops.image import (crop_and_resize,
                                                 get_nonzero_region_tuple,
                                                 save_image, tensor2numpy)
from contexture_nerf_tpu_torch.training.trainer import ConTEXTure

SURVEY = [
    ("shapes/spot_triangulated.obj", "a photo of a dairy cow"),
    ("shapes/bunny.obj", "a ceramic easter bunny"),
    ("shapes/nascar.obj", "a photo of a nascar racing car"),
]
MAX_RETRIES = 3
CROP = 320


def run_one(shape_path: str, prompt: str, out_dir: Path,
            overrides: Optional[Dict[str, dict]] = None, device="cuda",
            tiny_models: bool = False, **models
            ) -> Tuple[ConTEXTure, List[Path]]:
    """Paint one pair and write its 7 view crops into out_dir. `overrides`
    ({section: {key: value}}) go over the pair's config; `models`
    (teacher, mlp, diffusion) go to ConTEXTure in place of new random
    ones. Returns (the run, the files written)."""
    name = Path(shape_path).stem + "_" + "".join(
        c for c in prompt if c.isalnum() or c == " ").replace(" ", "_")[:40]
    data = {"log": {"exp_name": f"survey_{name}"},
            "guide": {"text": prompt, "shape_path": shape_path}}
    for section, values in (overrides or {}).items():
        data.setdefault(section, {}).update(values)
    trainer = ConTEXTure(config_from_dict(data), tiny_models=tiny_models,
                         device=device, **models)
    trainer.paint()

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, pose in enumerate(trainer.dataloaders["train"].poses()):
        out = trainer.mesh_model.render(
            trainer.mlp, theta=pose["theta"], phi=pose["phi"],
            radius=pose["radius"], background="white")
        bbox = get_nonzero_region_tuple(out["mask"][0, 0])
        tile = crop_and_resize(out["image"], bbox, CROP, CROP)
        written.append(save_image(tensor2numpy(tile[0].permute(1, 2, 0)),
                                  out_dir / f"{name}_view{i}.png"))
    return trainer, written


def main(argv: Optional[List[str]] = None, device="cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default="experiments/survey_renders")
    args = ap.parse_args(argv)
    for shape_path, prompt in SURVEY:
        if not Path(shape_path).exists():
            print(f"skip missing mesh {shape_path}")
            continue
        for attempt in range(MAX_RETRIES):
            try:
                run_one(shape_path, prompt, Path(args.out_dir), device=device)
                break
            except Exception:
                traceback.print_exc()
                print(f"retry {attempt + 1}/{MAX_RETRIES} for {shape_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
