"""The `sds_sv3d` cell at tiny size on the CPU: a sound run of `sds_orbit`
agrees with its plain reference (both in f32: the gaps are round-off);
the W8A8 control and every planted fault come out not correct under the
cell's limits; portbench/work/sv3d.py counts what
torch.utils.flop_counter counts on the reference step, and the GroupNorm
calls and elements the program's step makes. The readings at the cell's
own size, from which the limits were set, are in PERF.md."""

import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench import run as bench_run
from portbench import weights as W
from portbench.reference import sds as ref_sds
from portbench.reference import sv3d as ref
from portbench.reference import towers as rt
from portbench.work import sv3d as work

SEED = 2 ** 31 + 2121
# the seeds PERF.md gives the tiny control's readings for
SEEDS = [2 ** 31 + 2024, 2 ** 31 + 2121, 2 ** 31 + 5, 2 ** 31 + 77, 12345,
         2 ** 31 + 3]
CELL = "sds_sv3d"


def _line(seed=SEED, **kw):
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.1,
                                 trace=0)
    lines = []
    assert bench_run.run(args, torch, device="cpu", tiny=True,
                         out=lines.append, err=lambda s: None, **kw) == 0
    return json.loads(lines[-1])


def test_a_sound_tiny_run_agrees_with_its_reference():
    """Every number is f32 round-off: under 1e-3 (read 2e-6 to 1.5e-4 over
    six seeds and two thread counts; Adam's normalisation amplifies the
    round-off of small gradient entries), 30x under the least limit."""
    line = _line()
    assert line["correct"] and line["failed"] == 0, line["check"]
    assert all(v["value"] < 1e-3 for v in line["check"].values()), \
        line["check"]
    assert set(line["metrics"]) == {"sds_step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{"control": True}, {"fault": "unchanged"},
                                {"fault": "half_batch"},
                                {"fault": "altered"},
                                {"fault": "spatial_only"}],
                         ids=["control", "unchanged", "half_batch", "altered",
                              "spatial_only"])
def test_the_control_and_each_fault_are_not_correct(kw, seed):
    line = _line(seed, **kw)
    assert not line["correct"], line["check"]


def _tiny_reference():
    u, v = ref.VideoUNetConfig.tiny(), rt.VAEConfig.tiny()
    unet, enc = ref.VideoUNet(u), rt.Encoder(v)
    for name, m in (("unet", unet), ("vae_encoder", enc)):
        W.install(m, W.make_tower(W.spec(m), SEED, name, torch.device("cpu"),
                                  torch.float32))
    mlp = ref_sds.NeRF2D()
    W.install(mlp, W.make_mlp(W.spec(mlp), SEED, torch.device("cpu")),
              requires_grad=True)
    g = ref.orbit_frames(harness.ROOT / "shapes" / "torus.obj", 64, 32,
                         u.frames, 10.0, 0.6, 0.25, 1.5, "cpu")
    gen = torch.Generator().manual_seed(6)
    inputs = {"uv_pts": g["uv_pts"], "mask_frames": g["mask_frames"],
              "z_cond": torch.randn(1, 4, 16, 16, generator=gen),
              "context": torch.randn(1, 1, 32, generator=gen)}
    r = ref.OrbitSDSReference((unet, enc), mlp, inputs, 32, v,
                              (u.frames, 10.0, 1e-5, 2.5),
                              (1e-5, (0.9, 0.99), 1e-15))
    d = {"tile_idx": torch.tensor([2]),
         "eps": torch.randn(u.frames, 4, 16, 16, generator=gen),
         "noise": torch.randn(u.frames, 4, 16, 16, generator=gen)}
    return r, d, u, v


def test_step_flops_match_the_flop_counter():
    r, d, u, v = _tiny_reference()
    with FlopCounterMode(display=False) as fc:
        r.step(600, d)
    want = work.sds_step(u, v, u.frames, 32)["flops"]
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_k3_flops_at_the_published_shapes():
    """The spatial self-attentions of levels 0 (72^2 tokens) and 1 (36^2)
    route to K3, five of each a call at batch 42 frames; levels 2 and 3
    (18^2, 9^2 tokens) and the temporal and cross-attentions do not."""
    u = ref.VideoUNetConfig()
    got = work.video_unet(u, 2, 21, 72, 72)["k3_flops"]
    want = 5 * 4.0 * 42 * 5 * 5184 ** 2 * 64 + \
        5 * 4.0 * 42 * 10 * 1296 ** 2 * 64
    assert got == want


def test_groupnorm_calls_and_bytes_of_a_step():
    """The program's tiny step on the CPU: every GroupNorm module call's
    elements, against the count (f32 at tiny size: 8 bytes an element)."""
    from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
    from portbench.traffic import sds_orbit

    cell = harness.Cell(CELL)
    cell.params = dict(cell.params, check_steps=1)
    state = sds_orbit.setup(cell, SEED, torch, device="cpu", tiny=True)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].numel()))
        for tower in (state.teacher.unet, state.teacher.vae_encoder)
        for m in tower.modules() if isinstance(m, GroupNormSiLU)]
    try:
        state.trainer.step(state.ts[state.it])
    finally:
        for h in hooks:
            h.remove()
    w = state.work
    assert len(seen) == w["groupnorm_calls"]
    assert sum(seen) * 8 == w["k6_bytes"]
