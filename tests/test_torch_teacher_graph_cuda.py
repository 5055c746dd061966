"""The teacher's CUDA graphs (diffusion/teacher_graph.py) on the card, at
the SDS step's shapes: the full-width Zero123++ UNet and depth ControlNet
over a 120x80 latent (a 960x640 canvas), condition latents of 40x40, CFG
batch 2.

Marked `cuda`: without a CUDA device every test here skips. No JAX here;
on the card's machine run it with `--noconftest`, as
tests/test_torch_kernels_cuda.py.

A replayed call must equal the eager passes bit for bit (the graphs launch
the same kernels on the same inputs, the attention and GroupNorm calls run
eagerly between them) and launch the eager call's hand-written kernels,
each counted by its wrapper and seen by name on the card; `set_int8` drops
the graphs and the next calls rebuild them; the W8A8 towers of either
flag are captured and replayed; an input scale runs eagerly, three
branches and a swapped condition pair give the eager answer; between
calls, the graphs keep allocated no more than the bytes they state (the
allocator's requested bytes: its blocks round them up).
"""

import pytest
import torch

from contexture_nerf_tpu_torch.diffusion import teacher_graph as tg
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher

pytestmark = pytest.mark.cuda

GUIDANCE = 10.0
LATENT = (1, 4, 120, 80)


@pytest.fixture(scope="module")
def sds():
    """A full-width teacher with seeded random towers, the step's
    conditioning, and its first two calls made (eager, then captured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the teacher's "
                    "graphs on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    tch = Zero123PlusTeacher(device=dev, generator=g)
    cshape = (4, 40, 40)
    depth = torch.rand((1, 3, 960, 640), generator=g, device=dev)
    cond = {
        "cond_lat_pair": torch.randn((2,) + cshape, generator=g,
                                     device=dev).to(tch.dtype),
        "ehs": torch.randn((2, 77, 1024), generator=g,
                           device=dev).to(tch.dtype),
        "depth": depth,
        "cn_cond_emb": tch.embed_control_cond(depth, LATENT[2:]),
    }
    for seed in (1, 2):
        _call(tch, cond, _draws(dev, cshape, 300, seed))
    assert tch.graphs.counts["captures"] == 1
    return tch, cond, dev, cshape


def _draws(dev, cshape, t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"latents": torch.randn(LATENT, generator=g, device=dev),
            "t": torch.tensor([t], device=dev),
            "neg_noise": torch.randn(cshape, generator=g, device=dev),
            "cond_noise": torch.randn(cshape, generator=g, device=dev)}


def _call(tch, c, d, **kw):
    with torch.no_grad():
        return tch._cfg_v_pred(d["latents"], d["t"], c["cond_lat_pair"],
                               c["ehs"], c["depth"], GUIDANCE, d["neg_noise"],
                               d["cond_noise"], cn_cond_emb=c["cn_cond_emb"],
                               **kw)


def _eager(tch, c, d, scale_input=None):
    """The CFG combination of the passes, run eagerly."""
    with torch.no_grad():
        v_u, v_c = tch._cfg_passes(
            d["latents"], d["t"], c["cond_lat_pair"], c["ehs"], None,
            d["neg_noise"], d["cond_noise"], c["cn_cond_emb"],
            scale_input=scale_input).chunk(2)
    return v_u + GUIDANCE * (v_c - v_u)


@pytest.mark.parametrize("t,seed", [(980, 21), (500, 22), (40, 23)])
def test_a_replayed_call_is_bit_identical_to_the_eager_call(sds, t, seed):
    tch, cond, dev, cshape = sds
    d = _draws(dev, cshape, t, seed)
    n = tch.graphs.counts["replays"]
    got = _call(tch, cond, d)
    assert tch.graphs.counts["replays"] == n + 1
    want = _eager(tch, cond, d)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_set_int8_drops_the_graphs_and_the_next_calls_rebuild_them(sds):
    tch, cond, dev, cshape = sds
    tch.set_int8()
    assert tch.graphs.static_bytes() == 0
    before = dict(tch.graphs.counts)
    outs = [_call(tch, cond, _draws(dev, cshape, 600, 31 + i)).clone()
            for i in range(3)]
    got = {k: tch.graphs.counts[k] - before[k] for k in before}
    assert got == {"captures": 1, "replays": 1, "eager": 1, "fallbacks": 0}
    for i, out in enumerate(outs):
        assert torch.equal(out, _eager(tch, cond,
                                       _draws(dev, cshape, 600, 31 + i)))


@pytest.mark.parametrize("flags", [(True, False), (False, True)],
                         ids=["int8_controlnet", "int8_teacher"])
def test_the_w8a8_towers_are_captured_and_replayed(sds, flags):
    tch, cond, dev, cshape = sds
    tch.set_int8(*flags)
    try:
        before = dict(tch.graphs.counts)
        for i in range(3):
            d = _draws(dev, cshape, 600, 41 + i)
            assert torch.equal(_call(tch, cond, d), _eager(tch, cond, d))
        got = {k: tch.graphs.counts[k] - before[k] for k in before}
        stats = tch.graphs.stats()
        print(f"W8A8 {flags}: {stats}")
        assert got == {"captures": 1, "replays": 1, "eager": 1,
                       "fallbacks": 0}, stats
    finally:
        tch.set_int8()


def test_a_replay_launches_the_hand_kernels_of_the_eager_call(sds):
    """K3/K4 and K6 run eagerly between the graphs: a replay launches what
    the eager call launches, as the wrappers count it and as the card's
    trace names its kernels."""
    from torch.profiler import ProfilerActivity, profile

    tch, cond, dev, cshape = sds
    d = _draws(dev, cshape, 350, 91)
    for _ in range(2):  # eager and captured, if set_int8 dropped the graphs
        _call(tch, cond, d)
    _build.reset_launch_counts()
    _eager(tch, cond, d)
    eager = dict(_build.launch_counts)
    _build.reset_launch_counts()
    n = tch.graphs.counts["replays"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _call(tch, cond, d)
        torch.cuda.synchronize()
    assert tch.graphs.counts["replays"] == n + 1
    replay = dict(_build.launch_counts)
    _build.reset_launch_counts()
    assert replay == eager and eager["groupnorm"] > 0
    assert eager["flash_attn_single"] + eager["flash_attn_two_source"] > 0
    by_name = {}
    for e in prof.key_averages():
        for k in ("gn_fused", "flash_fwd_kernel"):
            if k in e.key:
                by_name[k] = by_name.get(k, 0) + e.count
    assert by_name == {
        "gn_fused": replay["groupnorm"],
        "flash_fwd_kernel": replay["flash_attn_single"]
        + replay["flash_attn_two_source"]}


def test_an_input_scale_runs_eagerly(sds):
    tch, cond, dev, cshape = sds
    d = _draws(dev, cshape, 700, 51)
    n = tch.graphs.eager["an input scale"]
    for _ in range(3):
        got = _call(tch, cond, d, scale_input=lambda x: 0.3 * x)
        assert torch.equal(got, _eager(tch, cond, d, lambda x: 0.3 * x))
    assert tch.graphs.eager["an input scale"] == n + 3


def test_three_branches_give_the_eager_answer(sds):
    tch, cond, dev, cshape = sds
    neg, pos = cond["cond_lat_pair"].chunk(2)
    u, c = cond["ehs"].chunk(2)
    captures = tch.graphs.counts["captures"]
    for i in range(3):
        d = _draws(dev, cshape, 250, 61 + i)
        with torch.no_grad():
            got = tch._cfg_v_pred_individual(
                d["latents"], d["t"], cond["cond_lat_pair"], cond["ehs"],
                cond["depth"], 3.0, 7.0, d["neg_noise"], d["cond_noise"],
                cn_cond_emb=cond["cn_cond_emb"])
            v_u, v_img, v_full = tch._cfg_passes(
                d["latents"], d["t"], torch.cat([neg, pos, pos]),
                torch.cat([u, u, c]), None, d["neg_noise"], d["cond_noise"],
                cond["cn_cond_emb"]).chunk(3)
        assert torch.equal(got, v_u + 3.0 * (v_img - v_u)
                           + 7.0 * (v_full - v_img))
    assert tch.graphs.counts["captures"] == captures + 1


def test_a_swapped_condition_pair_gives_the_eager_answer(sds):
    tch, cond, dev, cshape = sds
    d = _draws(dev, cshape, 450, 71)
    _call(tch, cond, d)
    first = _call(tch, cond, d).clone()
    swapped = dict(cond, cond_lat_pair=cond["cond_lat_pair"].flip(0)
                   .contiguous())
    n = tch.graphs.counts["replays"]
    got = _call(tch, swapped, d)
    assert tch.graphs.counts["replays"] == n + 1
    assert torch.equal(got, _eager(tch, swapped, d))
    assert not torch.equal(got, first)


def test_between_calls_the_graphs_keep_only_their_static_bytes(sds):
    tch, cond, dev, cshape = sds
    tch.set_int8()
    tg._capture_stream(dev)
    seen = []
    for i in range(5):
        out = _call(tch, cond, _draws(dev, cshape, 800, 81 + i))
        del out
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_stats()["requested_bytes.all.current"])
    held = tch.graphs.static_bytes()
    assert 0 < held < 30 * 2 ** 20
    # the first call eager, the second captured, then replays; while any
    # graph lives, torch keeps its CUDA generator's seed and offset for
    # graphs, two int64
    assert seen[1] - seen[0] <= held + 16
    assert seen[2:] == [seen[1]] * 3
