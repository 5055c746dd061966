"""The port's repaint pass and the depth-grid driver against the JAX
reference, tiny models, f32, on the CPU, on shapes/torus.obj:

- two `ConTEXTure.paint_viewpoint` passes of the front pose, held to the
  reference's two passes: paint step 1, then the repaint (the render with
  the median fill, the inpaint UNet at 10 < i < 20), with the same MLP and
  SD2-depth weights (the reference's, perturbed off the init, carried
  across by weights.py) and the reference's img2img draws
  (PRNGKey(optim.seed) split four ways, as both passes use);
- the first pass equal, bit for bit, to the front view of the port's
  `prepare_sds` on the same draws: prepare_sds paints as it did;
- `get_depth_maps_cond_grid.main` at tiny size: its depth grid held to the
  reference driver's arithmetic on the reference's geometry, its two PNGs
  at the sizes `check_gt_zero123plus.main` reads, which writes the grid
  and the six views from them.

Tolerances: each pass runs 51 UNet steps under CFG at 7.5 and a decode in
f32; the outputs agree to 4.6e-6 and 1.0e-5 on [0, 1] (measured; the
inpaint steps add the masked crop's encode), held to 2e-4 as
test_torch_sd_depth.py holds img2img. The depth grid agrees to 7.5e-5 (the
torus's faces seen edge-on, held to the 3e-4 test_torch_raster.py states
for them); its PNG, truncated to uint8, within one level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.ops.grid import merge_6_to_grid as j_merge
from contexture_nerf_tpu.ops.image import crop_and_resize as j_crop
from contexture_nerf_tpu.ops.image import \
    get_nonzero_region_tuple as j_bbox
from contexture_nerf_tpu.training.trainer import ConTEXTure as JConTEXTure
from contexture_nerf_tpu_torch import (check_gt_zero123plus,
                                       get_depth_maps_cond_grid, weights)
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion.sd_depth import (DRAWS,
                                                          StableDiffusionDepth)
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.ops.image import get_nonzero_region_tuple
from contexture_nerf_tpu_torch.training.trainer import (
    ConTEXTure, define_view_weights, prepare_sds)

TORUS = "shapes/torus.obj"
TEXT = "a photo of a dairy cow"
OUT_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(tmp, root):
    return {
        "log": {"exp_name": "torch_repaint", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": TEXT, "shape_path": str(root / TORUS),
                  "texture_resolution": 16},
        "optim": {"seed": 0},
    }


def _perturbed(tree, seed=0):
    """Every leaf moved off its init (norm scales off 1, biases off 0)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(int(np.prod(x.shape[:-1])))
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, request):
    """The reference's two paint_viewpoint passes of the front pose."""
    tmp = tmp_path_factory.mktemp("torch_repaint")
    root = request.config.rootpath
    tr = JConTEXTure(config_from_dict(_cfg_dict(tmp, root)),
                     tiny_models=True, backend="xla")
    tr.diffusion.params = jax.tree.map(jnp.asarray,
                                       _perturbed(tr.diffusion.params, 7))
    tr.text_z, tr.text_string = tr._calc_text_embeddings()
    pose = tr.dataloaders["train"].poses()[0]
    passes = [tuple(np.asarray(x) for x in tr.paint_viewpoint(
        pose, should_project_back=False)) for _ in range(2)]
    assert tr.paint_step == 2
    return tmp, root, tr, pose, passes


def _draws(cfg, sd):
    keys = jax.random.split(jax.random.PRNGKey(cfg.optim.seed), 4)
    return {k: torch.from_numpy(np.array(jax.random.normal(
        kk, sd.latent_shape()))) for k, kk in zip(DRAWS, keys)}


@pytest.fixture(scope="module")
def port(reference):
    tmp, root, tr, pose, _ = reference
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    sd = StableDiffusionDepth(tiny=True, device="cpu")
    weights.load_sd_depth(sd, jax.tree.map(np.asarray, tr.diffusion.params))
    cfg = torch_config_from_dict(_cfg_dict(tmp, root))
    ct = ConTEXTure(cfg, tiny_models=True, device="cpu", mlp=mlp,
                    diffusion=sd)
    draws = _draws(cfg, sd)
    calls = []  # GroupNorm calls of each pass
    for m in sd.modules():
        if isinstance(m, GroupNormSiLU):
            m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
    passes, n_calls = [], []
    for _ in range(2):
        calls.clear()
        passes.append(ct.paint_viewpoint(pose, should_project_back=False,
                                         draws=draws))
        n_calls.append(len(calls))
    return ct, draws, passes, n_calls


@pytest.mark.parametrize("step", [1, 2])
def test_paint_viewpoint_passes_match_reference(reference, port, step):
    """Pass 1 (paint step 1) and pass 2 (the repaint: median fill,
    inpainting) against the reference's."""
    _, _, _, _, ref_passes = reference
    ct, _, passes, _ = port
    assert ct.paint_step == 2
    rgb, mask = passes[step - 1]
    r_rgb, r_mask = ref_passes[step - 1]
    np.testing.assert_array_equal(mask.numpy(), r_mask)
    assert float(rgb.min()) >= 0 and float(rgb.max()) <= 1
    np.testing.assert_allclose(rgb.numpy(), r_rgb, rtol=0, atol=OUT_TOL)


def test_repaint_differs_and_keeps_the_background(port):
    """The repaint is another image inside the object's box (the inpaint
    UNet and the median-filled render), and the same outside it (both keep
    the render's background there). The repaint makes more GroupNorm
    calls than the first pass: its 9 inpaint UNet calls and the encode of
    its masked crop."""
    ct, _, passes, n_calls = port
    (a, mask), (b, _) = passes
    mh, mw, Mh, Mw = get_nonzero_region_tuple(mask[0, 0])
    box = torch.zeros_like(a, dtype=torch.bool)
    box[..., mh:Mh, mw:Mw] = True
    assert torch.equal(a[~box], b[~box])
    assert float((a[box] - b[box]).abs().max()) > 1e-2
    assert n_calls[1] > n_calls[0]


def test_prepare_sds_paints_as_before(reference, port):
    """prepare_sds's front view is paint step 1's output, bit for bit."""
    tmp, root, _, _, _ = reference
    ct, draws, passes, _ = port
    setup = prepare_sds(ct.cfg, ct.mesh_model, ct.mlp, ct.teacher,
                        generator=torch.Generator().manual_seed(0),
                        diffusion=ct.diffusion, bootstrap_draws=draws)
    assert torch.equal(setup["front_rgb"], passes[0][0])


def _reference_depth_grid(tr, tile):
    """The reference driver's depth grid (get_depth_maps_cond_grid.py's
    loop) on the reference's 7-view geometry."""
    tr.define_view_weights()
    cache = tr._geometry_cache
    depth, masks = 1.0 - cache.depth_map, cache.mask
    masks_np = np.asarray(masks[:, 0])
    tiles = []
    for i in range(1, depth.shape[0]):
        bbox = j_bbox(masks_np[i])
        d = j_crop(depth[i:i + 1], bbox, tile, tile)
        a = j_crop(masks[i:i + 1], bbox, tile, tile)
        tiles.append(jnp.concatenate([d, d, d], 1) * a + 0.5 * (1 - a))
    return np.asarray(j_merge(jnp.concatenate(tiles, 0)))


def test_depth_grid_driver_feeds_check_gt(reference, tmp_path):
    from PIL import Image

    _, root, tr, _, _ = reference
    out = tmp_path / "grids"
    ct, rgb, mask = get_depth_maps_cond_grid.main(
        ["--shape_path", str(root / TORUS), "--text", TEXT, "--out_dir",
         str(out), "--tiny", "--render.train_grid_size=32",
         "--guide.texture_resolution=16", "--log.log_images=false"],
        device="cpu")
    assert ct.paint_step == 1
    assert rgb.shape == (1, 3, 32, 32) and mask.shape == (1, 1, 32, 32)
    tile = ct.teacher.tile_px
    ref = _reference_depth_grid(tr, tile)
    cache, _ = define_view_weights(ct.mesh_model, ct.cfg.render)
    grid = get_depth_maps_cond_grid.depth_grid(cache, tile)
    # faces seen edge-on on the torus: the camera math's rounding times
    # 1/den moves depth by up to 3e-4 (test_torch_raster.py); 7.5e-5 here
    np.testing.assert_allclose(grid.numpy(), ref, rtol=0, atol=3e-4)
    png = np.asarray(Image.open(out / "depth_grid.png"), np.int32)
    assert png.shape == (3 * tile, 2 * tile, 3)
    want = (ref[0].transpose(1, 2, 0) * 255).astype(np.int32)
    assert np.abs(png - want).max() <= 1
    assert Image.open(out / "cond_image.png").size == (tile, tile)
    assert (out / "depth_grid" / "config.yaml").exists()

    gt = tmp_path / "gt"
    check_gt_zero123plus.main(
        ["--cond", str(out / "cond_image.png"), "--depth_grid",
         str(out / "depth_grid.png"), "--out_dir", str(gt), "--steps", "2",
         "--tiny"], device="cpu")
    assert sorted(p.name for p in gt.iterdir()) == \
        ["grid.png"] + [f"view_{i}.png" for i in range(6)]
    assert Image.open(gt / "grid.png").size == (2 * tile, 3 * tile)
