"""The census of kernel-routed calls (tools/launches.py in the port) on the
CPU at tiny size, and the structure it relies on.

The census counts, as a run makes them, the calls that launch K3/K4 (the
attention calls the routing rule sends to the flash kernel), K6 (every
GroupNormSiLU call) and gn_bwd (those whose backward runs). Here it is held
to counts taken another way: hooks on the towers' GroupNorms, the VAE
encoder's GroupNorm modules, and the lengths of every attention call put
through `routes_to_kernel`. The structural tests keep the census complete
for any tower: every GroupNorm of a tower is a GroupNormSiLU, every
attention goes through `ops.attention.attention` by a name the census wraps,
and softmax attention outside ops/attention.py runs only at the reference's
plain sites.
"""

import ast
from collections import Counter
from pathlib import Path

import pytest
import torch

from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.diffusion import layers
from contexture_nerf_tpu_torch.diffusion.controlnet import ControlNet
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Decoder, Encoder,
                                                     VAEConfig)
from contexture_nerf_tpu_torch.diffusion.video_unet import (VideoUNet,
                                                            VideoUNetConfig)
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import attention as att
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.tools import launches
from contexture_nerf_tpu_torch.tools.launches import census
from contexture_nerf_tpu_torch.training.trainer import (GUIDANCE_SCALE,
                                                        build_sds_trainer)
from tools.make_shapes import uv_sphere, write_obj

PKG = Path(__file__).resolve().parent.parent / "contexture_nerf_tpu_torch"
T = 500

# The towers of the port at their published widths, built on the meta
# device (no memory): name -> a function making it.
TOWERS = {
    "zero123plus UNet": lambda: UNet2DCondition(UNetConfig.zero123plus()),
    "depth ControlNet": lambda: ControlNet(UNetConfig.zero123plus()),
    "SD VAE encoder": lambda: Encoder(VAEConfig.sd()),
    "SD VAE decoder": lambda: Decoder(VAEConfig.sd()),
    "SD2-depth UNet": lambda: UNet2DCondition(UNetConfig.sd2_depth()),
    "SD2-inpaint UNet": lambda: UNet2DCondition(UNetConfig.sd2_inpaint()),
    "SV3D_p VideoUNet": lambda: VideoUNet(VideoUNetConfig.sv3d_p()),
}
# Where softmax attention may run outside ops/attention.py: the
# reference's plain sites, by file and enclosing function.
PLAIN_SOFTMAX_SITES = {("diffusion/vae.py", "VAEAttention.forward"),
                       ("diffusion/clip.py", "CLIPLayer.forward")}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A tiny SDS trainer on the CPU with local_sds_grad: a step encodes
    the canvas without a gradient and the slice with one."""
    tmp = tmp_path_factory.mktemp("launches")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    cfg = config_from_dict({
        "log": {"exp_name": "launches", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "launches", "shape_path": str(tmp / "s.obj"),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "local_sds_grad": True,
                  "local_sds_margin_px": 8,
                  "precompute_uv_embedding": True}})
    trainer, _ = build_sds_trainer(cfg, tiny=True, device="cpu",
                                   skip_bootstrap=True)
    assert trainer.local_grad
    return trainer


def _groupnorms(module):
    return [m for m in module.modules() if isinstance(m, GroupNormSiLU)]


def test_a_step_census_counts_every_groupnorm_and_the_differentiated_encode(
        trainer):
    """K6: every GroupNormSiLU call of the step, as hooks on the teacher's
    modules count them; gn_bwd: one for each GroupNorm of the one encode the
    loss differentiates (the slice's), none for the canvas's or the
    teacher's; and a CPU step launches nothing."""
    seen = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, tower=tower: seen.update([tower]))
        for tower, module in (("vae", trainer.teacher.vae_encoder),
                              ("all", trainer.teacher))
        for m in _groupnorms(module)]
    before = dict(_build.launch_counts)
    try:
        with census() as c:
            trainer.step(T)
    finally:
        for h in hooks:
            h.remove()
    per_encode = len(_groupnorms(trainer.teacher.vae_encoder))
    assert per_encode > 0
    assert seen["vae"] == 2 * per_encode  # the canvas, then the slice
    assert c.counts["groupnorm"] == seen["all"] > seen["vae"]
    assert c.counts["groupnorm_bwd"] == per_encode
    assert _build.launch_counts == before


@pytest.mark.parametrize("thresholds", ["the rule's", "patched"])
def test_a_teacher_call_census_splits_attention_as_the_routing_rule(
        trainer, monkeypatch, thresholds):
    """Every attention call of a teacher call, its lengths put through
    routes_to_kernel: the census counts the routed ones by source (K3
    single, K4 with the reference tokens) and keeps their inputs; the
    others take the plain route. Both routes occur under the rule's
    thresholds and under patched ones that move the split."""
    lengths = []
    orig = layers.attention

    def record(q, k, v, extra_k=None, extra_v=None):
        lengths.append((q.shape[2], k.shape[2],
                        0 if extra_k is None else extra_k.shape[2]))
        return orig(q, k, v, extra_k=extra_k, extra_v=extra_v)

    monkeypatch.setattr(layers, "attention", record)
    if thresholds == "patched":
        monkeypatch.setattr(att, "MIN_KV_KERNEL", att.MIN_SQ_KERNEL)
    t = trainer
    g = torch.Generator().manual_seed(1)
    z = torch.randn(t.latent_shape(), generator=g)
    with torch.no_grad(), census(keep_calls=True) as c:
        t.teacher.teacher_v_pred(z, torch.tensor([T]), t.cond_lat_pair,
                                 t.ehs, t.depth_grid, GUIDANCE_SCALE,
                                 generator=g, cn_cond_emb=t.cn_cond_emb)
    routed = [n for n in lengths if att.routes_to_kernel(*n)]
    single = sum(1 for n in routed if not n[2])
    assert 0 < len(routed) < len(lengths)
    assert single > 0 and len(routed) - single > 0
    assert c.counts["flash_attn_single"] == single
    assert c.counts["flash_attn_two_source"] == len(routed) - single
    assert c.counts["groupnorm_bwd"] == 0
    assert [(q.shape[2], k.shape[2], 0 if ek is None else ek.shape[2])
            for q, k, _, ek, _ in c.calls] == routed
    if thresholds == "patched":  # the write pass's 256 tokens route too
        assert (256, 256, 0) in routed


def test_the_census_leaves_nothing_behind():
    """After the census the towers call ops.attention.attention again and
    no module hook is left."""
    hooks = torch.nn.modules.module._global_forward_pre_hooks
    n = len(hooks)
    with census():
        assert len(hooks) == n + 1
        assert all(m.attention is not att.attention
                   for m in launches.ATTENTION_SITES)
    assert len(hooks) == n
    assert all(m.attention is att.attention
               for m in launches.ATTENTION_SITES)


@pytest.mark.parametrize("name", list(TOWERS))
def test_every_groupnorm_of_a_tower_is_a_groupnorm_silu(name):
    """A tower's normalisations go through ops/groupnorm.py, so K6's
    census sees every one: no torch.nn.GroupNorm in any tower."""
    with torch.device("meta"):
        tower = TOWERS[name]()
    assert _groupnorms(tower)
    assert not [n for n, m in tower.named_modules()
                if isinstance(m, torch.nn.GroupNorm)]


def _calls(path: Path):
    """(enclosing Class.function, the called name as written, such as
    "F.group_norm" or "self.group_norm") of every call in a file."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.ClassDef, ast.FunctionDef)):
                inner = f"{scope}.{child.name}" if scope else child.name
            if isinstance(child, ast.Call):
                out.append((scope, ast.unparse(child.func)))
            visit(child, inner)

    visit(ast.parse(path.read_text()), "")
    return out


def test_no_tower_calls_the_library_group_norm_or_attention():
    """No module under diffusion/ calls F.group_norm or
    F.scaled_dot_product_attention: those would bypass K6 and the routing
    rule, and the census with them."""
    found = [(p.name, scope, name) for p in (PKG / "diffusion").glob("*.py")
             for scope, name in _calls(p) if not name.startswith("self.")
             and name.split(".")[-1] in ("group_norm",
                                         "scaled_dot_product_attention")]
    assert not found


def test_softmax_attention_runs_only_at_the_plain_sites():
    """Outside ops/attention.py, softmax runs only at the reference's plain
    attention sites: the VAE mid-block and CLIP's causal text attention."""
    found = {(str(p.relative_to(PKG)), scope)
             for p in PKG.rglob("*.py") if p != PKG / "ops" / "attention.py"
             for scope, name in _calls(p)
             if name.split(".")[-1] == "softmax"}
    assert found == PLAIN_SOFTMAX_SITES


def test_the_census_wraps_every_module_that_calls_attention():
    """Every module of the port that imports ops.attention.attention is a
    site the census wraps."""
    importers = set()
    for p in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "contexture_nerf_tpu_torch.ops.attention" \
                    and any(a.name == "attention" for a in node.names):
                importers.add(".".join(p.relative_to(PKG.parent)
                                       .with_suffix("").parts))
    assert importers == {m.__name__ for m in launches.ATTENTION_SITES}
