"""The `sds_flux` cell at tiny size on the CPU: a sound run of `sds_flow`
agrees with its plain reference (both in f32: the gaps are round-off);
every planted fault, `no_rope` (the rotary embedding skipped in every
block) among them, comes out not correct under the cell's limits;
portbench/work/flux.py counts what torch.utils.flop_counter counts on the
reference step, and K3's FLOPs at the published shapes. The readings at
the cell's own size, from which the limits were set, are in PERF.md; the
W8A8 control is held by test_portbench_control.py."""

import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench import run as bench_run
from portbench import weights as W
from portbench.reference import flux as ref
from portbench.reference import geometry as geo
from portbench.reference import sds as ref_sds
from portbench.work import flux as work

SEED = 2 ** 31 + 2525
SEEDS = [2 ** 31 + 2024, 2 ** 31 + 2525, 12345]
CELL = "sds_flux"


def _line(seed=SEED, **kw):
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.1,
                                 trace=0)
    lines = []
    assert bench_run.run(args, torch, device="cpu", tiny=True,
                         out=lines.append, err=lambda s: None, **kw) == 0
    return json.loads(lines[-1])


def test_a_sound_tiny_run_agrees_with_its_reference():
    """Every number is f32 round-off: under 1e-3 (read 8e-8 to 1.7e-4 over
    SEEDS with 2 threads, 6.7e-4 in change_gap with 4: Adam's
    normalisation amplifies the round-off of small gradient entries), far
    under the least limit."""
    line = _line()
    assert line["correct"] and line["failed"] == 0, line["check"]
    assert all(v["value"] < 1e-3 for v in line["check"].values()), \
        line["check"]
    assert set(line["metrics"]) == {"sds_step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "no_rope"])
def test_each_planted_fault_is_not_correct(fault, seed):
    line = _line(seed, fault=fault)
    assert not line["correct"], line["check"]


def test_step_flops_match_the_flop_counter():
    plain = ref.Flux(ref.Config.tiny())
    vae = ref.ae_encoder(ref.vae_config(True))
    for name, m in (("transformer", plain), ("vae_encoder", vae)):
        W.install(m, W.make_tower(W.spec(m), SEED, name, torch.device("cpu"),
                                  torch.float32))
    mlp = ref_sds.NeRF2D()
    W.install(mlp, W.make_mlp(W.spec(mlp), SEED, torch.device("cpu")),
              requires_grad=True)
    g = geo.six_views(harness.ROOT / "shapes" / "torus.obj", 96, 32, 0.6,
                      0.25, 1.5, "cpu")
    gen = torch.Generator().manual_seed(4)
    inputs = {"depth_grid": g["depth_grid"], "mask_grid": g["mask_grid"],
              "uv_pts": g["uv_pts"],
              "txt": torch.randn(1, 8, 32, generator=gen),
              "vec": torch.randn(1, 16, generator=gen)}
    r = ref.FluxSDSReference((plain, vae), mlp, inputs, 32, 64,
                             (1e-5, (0.9, 0.99), 1e-15))
    d = {"tile_idx": torch.tensor([2]),
         "eps": torch.randn(1, 16, 48, 32, generator=gen),
         "noise": torch.randn(1, 16, 48, 32, generator=gen)}
    with FlopCounterMode(display=False) as fc:
        r.step(600, d)
    want = work.sds_step(ref.Config.tiny(), ref.vae_config(True), 32, 8, 64)
    assert fc.get_total_flops() == pytest.approx(want["flops"], rel=1e-9)


def test_the_published_call_and_k3_flops():
    """57 joint attentions over 2,400 + 512 tokens, 24 heads of 128, all
    routed to K3: 5.94 TFLOP; the call 43.56 TFLOP, 113.2 M multiply-adds
    a token a block in the blocks' linears."""
    cfg = ref.Config()
    w = work.sds_step(cfg, ref.vae_config(False), 320, 512, 64)
    assert w["image_tokens"] == 2400
    assert w["k3_flops"] == 57 * 4.0 * 24 * 2912 ** 2 * 128
    assert 12 * cfg.hidden_size ** 2 == 113_246_208
    assert w["parts"]["teacher"] == pytest.approx(43.56e12, rel=1e-3)
