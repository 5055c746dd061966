"""The teacher's CUDA-graph replay (diffusion/teacher_graph.py) on the CPU:
what holds without a card. A teacher call on CPU tensors never captures
(every call eager, counted by its reason) and returns the CFG combination
of its passes; while a capture is open, and only on its thread, every
call of the attention entry and of a GroupNormSiLU module is cut out to
the recorder with a slot shaped, laid out and typed as its output, and a
teacher call cut so equals the eager call; a copy of the teacher starts
with no graphs. The capture and the replay themselves run only on the card
(tests/test_torch_teacher_graph_cuda.py)."""

import copy
import threading

import pytest
import torch

from contexture_nerf_tpu_torch.diffusion import layers
from contexture_nerf_tpu_torch.diffusion import teacher_graph as tg
from contexture_nerf_tpu_torch.diffusion.teacher_graph import TeacherGraphs
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.tools.launches import census
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher

GUIDANCE = 10.0


@pytest.fixture(scope="module")
def teacher():
    """A tiny teacher on the CPU and one call's inputs: a 3x2 grid's
    latent, the CFG pair's condition latents and hidden states, the depth
    hint's embedding and the write pass's noises."""
    g = torch.Generator().manual_seed(3)
    tch = Zero123PlusTeacher(tiny=True, device="cpu", generator=g)
    lat = (1, 4, 3 * tch.tile_px // 8, 2 * tch.tile_px // 8)
    cond = (4, tch.tile_px // 8, tch.tile_px // 8)
    ctx = tch.unet_config.cross_attention_dim
    depth = torch.rand((1, 3, lat[2] * 8, lat[3] * 8), generator=g)
    inputs = {
        "latents": torch.randn(lat, generator=g),
        "t": torch.tensor([400]),
        "cond_lat_pair": torch.randn((2,) + cond, generator=g),
        "ehs": torch.randn((2, 77, ctx), generator=g),
        "depth": depth,
        "neg_noise": torch.randn(cond, generator=g),
        "cond_noise": torch.randn(cond, generator=g),
        "cn_cond_emb": tch.embed_control_cond(depth, lat[2:]),
    }
    return tch, inputs


def _call(tch, d, **kw):
    return tch._cfg_v_pred(d["latents"], d["t"], d["cond_lat_pair"],
                           d["ehs"], d["depth"], GUIDANCE, d["neg_noise"],
                           d["cond_noise"], cn_cond_emb=d["cn_cond_emb"], **kw)


def _passes(tch, d, scale_input=None):
    """The CFG combination of the passes, run directly."""
    v_u, v_c = tch._cfg_passes(
        d["latents"], d["t"], d["cond_lat_pair"], d["ehs"], None,
        d["neg_noise"], d["cond_noise"], d["cn_cond_emb"],
        scale_input=scale_input).chunk(2)
    return v_u + GUIDANCE * (v_c - v_u)


def test_the_teacher_on_the_cpu_never_captures(teacher):
    tch, d = teacher
    tch.graphs = TeacherGraphs()
    first, second = _call(tch, d), _call(tch, d)
    scaled = _call(tch, d, scale_input=lambda x: 0.5 * x)
    assert torch.equal(first, _passes(tch, d))
    assert torch.equal(second, first)
    assert torch.equal(scaled, _passes(tch, d, lambda x: 0.5 * x))
    assert not torch.equal(scaled, first)
    s = tch.graphs.stats()
    assert (s["captures"], s["replays"], s["eager"], s["fallbacks"]) == \
        (0, 0, 3, 0)
    assert s["eager_by_reason"] == {"an input off the card": 2,
                                    "an input scale": 1}
    assert s["static_bytes"] == 0


def test_three_branches_on_the_cpu_run_eagerly(teacher):
    tch, d = teacher
    tch.graphs = TeacherGraphs()
    v = tch._cfg_v_pred_individual(
        d["latents"], d["t"], d["cond_lat_pair"], d["ehs"], d["depth"], 3.0,
        7.0, d["neg_noise"], d["cond_noise"], cn_cond_emb=d["cn_cond_emb"])
    assert v.shape == d["latents"].shape and torch.isfinite(v).all()
    assert tch.graphs.counts == {"captures": 0, "replays": 0, "eager": 1,
                                 "fallbacks": 0}


def test_a_copy_of_the_teacher_starts_without_graphs(teacher):
    tch, d = teacher
    _call(tch, d)
    dup = copy.deepcopy(tch)
    assert dup.graphs is not tch.graphs
    assert dup.graphs.counts["eager"] == 0
    assert torch.equal(_call(dup, d), _call(tch, d))


def test_set_int8_drops_the_graphs(teacher, monkeypatch):
    tch, _ = teacher
    dropped = []
    monkeypatch.setattr(tch.graphs, "clear", lambda: dropped.append(1))
    tch.set_int8(int8_controlnet=True)
    tch.set_int8()
    assert dropped == [1, 1]


class _Recorder:
    """A stand-in for a capture: records each cut call (its kind, its
    slot's shape, strides and dtype), runs it and copies its output into
    the slot, as the capture does."""

    def __init__(self):
        self.seen = []

    def cut(self, slot, call, replay, args, kwargs):
        kind = "groupnorm" if isinstance(replay, GroupNormSiLU) \
            else "attention"
        self.seen.append((kind, slot.shape, slot.stride(), slot.dtype))
        out = call(*args, **kwargs)
        assert out.shape == slot.shape and out.dtype == slot.dtype
        slot.copy_(out)
        return slot


def _restored():
    return (layers.attention is tg.att.attention
            and "__call__" not in vars(GroupNormSiLU))


@pytest.mark.parametrize("ref", [False, True])
def test_cross_attention_hands_off_only_while_a_capture_is_open(ref):
    torch.manual_seed(0)
    attn = layers.CrossAttention(32, 32, 2, 16)
    x = torch.randn(2, 10, 32)
    ref_kv = torch.randn(2, 6, 32) if ref else None
    rec = _Recorder()
    before = attn(x, ref_kv=ref_kv)
    with tg._cutting(rec):
        handed = attn(x, ref_kv=ref_kv)
    after = attn(x, ref_kv=ref_kv)
    # K3/K4's layout: (B, Sq, H, d) memory viewed as (B, H, Sq, d)
    assert rec.seen == [("attention", torch.Size([2, 2, 10, 16]),
                         (320, 16, 32, 1), torch.float32)]
    assert _restored()
    assert torch.equal(handed, before) and torch.equal(after, before)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_groupnorm_calls_are_cut_only_while_a_capture_is_open(out_dtype):
    torch.manual_seed(0)
    gn = GroupNormSiLU(64, groups=32, out_dtype=out_dtype)
    x = torch.randn(2, 64, 5, 3)
    hooked = []
    h = gn.register_forward_pre_hook(lambda m, a: hooked.append(1))
    rec = _Recorder()
    try:
        before = gn(x)
        with tg._cutting(rec):
            cut = gn(x)
        after = gn(x)
    finally:
        h.remove()
    # the module's hooks fire once a call, cut or not
    assert hooked == [1, 1, 1]
    assert rec.seen == [("groupnorm", x.shape, x.stride(),
                         out_dtype or x.dtype)]
    assert _restored()
    assert torch.equal(cut, before) and torch.equal(after, before)


def test_another_threads_calls_are_not_cut():
    torch.manual_seed(0)
    attn = layers.CrossAttention(32, 32, 2, 16)
    gn = GroupNormSiLU(64, groups=32)
    x, y = torch.randn(2, 10, 32), torch.randn(1, 64, 4, 4)
    rec, got = _Recorder(), {}

    def other():
        got["attn"], got["gn"] = attn(x), gn(y)

    with tg._cutting(rec):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert rec.seen == []
    assert torch.equal(got["attn"], attn(x)) and torch.equal(got["gn"],
                                                               gn(y))


def test_a_cut_teacher_call_equals_the_eager_call(teacher, monkeypatch):
    """Every GroupNorm and attention call of a teacher call is cut, each
    once (the census's hook still counts each GroupNorm call once, a
    wrapper of the attention entry sees each attention call once), and
    the cut call's answer is the eager one bit for bit."""
    tch, d = teacher
    args = (d["latents"], d["t"], d["cond_lat_pair"], d["ehs"], None,
            d["neg_noise"], d["cond_noise"], d["cn_cond_emb"])
    entry, entered = layers.attention, []

    def counted(*a, **k):
        entered.append(1)
        return entry(*a, **k)

    monkeypatch.setattr(layers, "attention", counted)
    with torch.no_grad():
        with census(keep_calls=True) as eager_c:
            want = tch._cfg_passes(*args)
        rec = _Recorder()
        with census(keep_calls=True) as cut_c, tg._cutting(rec):
            n_eager = len(entered)
            got = tch._cfg_passes(*args)
    assert layers.attention is counted
    assert "__call__" not in vars(GroupNormSiLU)
    assert torch.equal(got, want)
    kinds = [s[0] for s in rec.seen]
    assert kinds.count("groupnorm") == eager_c.counts["groupnorm"] \
        == cut_c.counts["groupnorm"] > 0
    assert kinds.count("attention") == n_eager == len(entered) - n_eager > 0
    assert cut_c.counts == eager_c.counts


def test_the_recorder_is_closed_after_an_error():
    with pytest.raises(RuntimeError):
        with tg._cutting(_Recorder()):
            raise RuntimeError("capture failed")
    assert _restored()
