"""Ground-truth multiview generation from a condition image and a depth
grid: the counterpart of check_gt_zero123plus.py.

    python -m contexture_nerf_tpu_torch.check_gt_zero123plus \
        --cond cond_image.png --depth_grid depth_grid.png \
        [--out_dir experiments/zero123plus_gt] [--steps 28] [--tiny]

The inputs are what `python -m
contexture_nerf_tpu_torch.get_depth_maps_cond_grid` writes. Builds the
Zero123++ pipeline (UNet with reference attention, depth ControlNet, VAE,
CLIP towers) with random towers from seed 0, runs `generate` (the
EulerAncestral steps at guidance 4.0, draws from a generator seeded 0) on
the 3x2 canvas of the pipeline's tiles (960x640 at full width), and writes
grid.png and view_0.png ... view_5.png under --out_dir. The images are read
with Pillow and resized to the tile (the condition image) and to the canvas
(the depth grid), as the reference reads them; at tiny size the tile is 32
px where the reference keeps 320.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusPipeline
from contexture_nerf_tpu_torch.ops.grid import split_grid_to_6
from contexture_nerf_tpu_torch.ops.image import save_image, tensor2numpy

GUIDANCE_SCALE = 4.0
SEED = 0


def load_image(path, size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """An image file as (1,3,H,W) f32 in [0,1], resized by Pillow to
    size = (width, height) when given."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if size is not None:
        im = im.resize(size)
    arr = np.asarray(im, np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))[None]


def save_grid(grid: torch.Tensor, tile: int, out_dir: Path) -> List[Path]:
    """grid.png and view_{i}.png of a (1,3,3t,2t) grid in [0,1]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [save_image(tensor2numpy(grid[0].permute(1, 2, 0)),
                        out_dir / "grid.png")]
    for i, view in enumerate(split_grid_to_6(grid, tile)):
        paths.append(save_image(tensor2numpy(view.permute(1, 2, 0)),
                                out_dir / f"view_{i}.png"))
    return paths


def main(argv: Optional[List[str]] = None, device="cuda",
         tiny_models: bool = False,
         timings: Optional[Dict[str, float]] = None
         ) -> Tuple[Zero123PlusPipeline, torch.Tensor]:
    """Parse argv (sys.argv[1:] when None), generate on `device` and write
    the images; `timings` receives generate's phases. Returns (the
    pipeline, the (1,3,3t,2t) grid)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cond", required=True, help="front cond image png")
    ap.add_argument("--depth_grid", required=True, help="3x2 depth grid png")
    ap.add_argument("--out_dir", default="experiments/zero123plus_gt")
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--tiny", action="store_true",
                    help="test-size towers")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    pipe = Zero123PlusPipeline(
        tiny=args.tiny or tiny_models, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    t = pipe.tile_px
    cond = load_image(args.cond, (t, t)).to(dev) * 2 - 1
    depth = load_image(args.depth_grid, (2 * t, 3 * t)).to(dev)
    grid = pipe.generate(
        cond, depth, num_inference_steps=args.steps,
        guidance_scale=GUIDANCE_SCALE, height=3 * t, width=2 * t,
        generator=torch.Generator(device=dev).manual_seed(SEED),
        timings=timings)
    out_dir = Path(args.out_dir)
    save_grid(grid, t, out_dir)
    print(f"wrote {out_dir}")
    return pipe, grid


if __name__ == "__main__":
    main(sys.argv[1:])
