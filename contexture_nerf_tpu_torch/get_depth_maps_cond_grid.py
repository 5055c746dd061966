"""The depth grid and the front condition image of a mesh: the counterpart
of get_depth_maps_cond_grid.py.

    python -m contexture_nerf_tpu_torch.get_depth_maps_cond_grid \
        [--shape_path shapes/spot_triangulated.obj] \
        [--text "a photo of a cow"] [--out_dir experiments/depth_grids] \
        [--tiny] [--section.key=value ...]

Renders the 7 fixed views of the mesh (`define_view_weights`: K5 once on
the card) and writes depth_grid.png: each of the 6 target views cropped to
its object's box and resized to the tile, 1 - depth on 0.5 grey, merged
3x2 (960x640 at full width). Then paints the front view with
`ConTEXTure.paint_viewpoint` (the SD2-depth img2img of paint step 1) and
writes its object crop on grey at the tile's size as cond_image.png. The
two are what `python -m contexture_nerf_tpu_torch.check_gt_zero123plus`
reads, at its sizes. Random towers from the config's seed; the run's
config, log and debug images go under <out_dir>/depth_grid/. Further
--section.key=value arguments override the config, as in run_contexture
(for example --render.train_grid_size=64).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from contexture_nerf_tpu_torch.core.config import load_config
from contexture_nerf_tpu_torch.ops.grid import merge_6_to_grid
from contexture_nerf_tpu_torch.ops.image import (crop_and_resize,
                                                 get_nonzero_region_tuple,
                                                 save_image, tensor2numpy)
from contexture_nerf_tpu_torch.raster.render import RenderCache
from contexture_nerf_tpu_torch.training.trainer import (ConTEXTure,
                                                        define_view_weights)


def depth_grid(cache: RenderCache, tile: int) -> torch.Tensor:
    """(1,3,3t,2t): views 1..6 of a 7-view geometry pass, each cropped to
    its object's box and resized to the tile, 1 - depth on 0.5 grey."""
    depth, masks = 1.0 - cache.depth_map, cache.mask
    tiles = []
    for i in range(1, depth.shape[0]):
        bbox = get_nonzero_region_tuple(masks[i, 0])
        d = crop_and_resize(depth[i:i + 1], bbox, tile, tile)
        a = crop_and_resize(masks[i:i + 1], bbox, tile, tile)
        tiles.append(torch.cat([d, d, d], dim=1) * a + 0.5 * (1 - a))
    return merge_6_to_grid(torch.cat(tiles))


def cond_image(rgb: torch.Tensor, mask: torch.Tensor,
               tile: int) -> torch.Tensor:
    """(1,3,t,t): the object's crop of a painted view on 0.5 grey."""
    bbox = get_nonzero_region_tuple(mask[0, 0])
    a = crop_and_resize(mask, bbox, tile, tile)
    return crop_and_resize(rgb, bbox, tile, tile) * a + 0.5 * (1 - a)


def save_chw(img: torch.Tensor, path: Path) -> Path:
    return save_image(tensor2numpy(img[0].permute(1, 2, 0)), path)


def main(argv: Optional[List[str]] = None, device="cuda",
         tiny_models: bool = False,
         timings: Optional[Dict[str, float]] = None, **models
         ) -> Tuple[ConTEXTure, torch.Tensor, torch.Tensor]:
    """Parse argv (sys.argv[1:] when None), render and paint on `device`,
    write depth_grid.png and cond_image.png under --out_dir. `models`
    (teacher, mlp, diffusion) go to ConTEXTure in place of new random
    ones; `timings` receives the paint pass's phases. Returns (the run,
    its paint_step at 1; the painted front view (1,3,H,W); its object
    mask (1,1,H,W))."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape_path", default="shapes/spot_triangulated.obj")
    ap.add_argument("--text", default="a photo of a cow")
    ap.add_argument("--out_dir", default="experiments/depth_grids")
    ap.add_argument("--tiny", action="store_true",
                    help="test-size diffusion models")
    args, overrides = ap.parse_known_args(argv)
    out_dir = Path(args.out_dir)
    cfg = load_config(overrides)
    cfg.log.exp_name = "depth_grid"
    cfg.log.exp_root = out_dir
    cfg.guide.text = args.text
    cfg.guide.shape_path = args.shape_path
    trainer = ConTEXTure(cfg, tiny_models=args.tiny or tiny_models,
                         device=device, **models)
    tile = trainer.teacher.tile_px
    cache, _ = define_view_weights(trainer.mesh_model, cfg.render)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_chw(depth_grid(cache, tile), out_dir / "depth_grid.png")
    del cache

    pose = trainer.dataloaders["train"].poses()[0]
    rgb, mask = trainer.paint_viewpoint(pose, should_project_back=False,
                                        timings=timings)
    save_chw(cond_image(rgb, mask, tile), out_dir / "cond_image.png")
    print(f"wrote {out_dir}/depth_grid.png and cond_image.png")
    return trainer, rgb, mask


if __name__ == "__main__":
    main(sys.argv[1:])
