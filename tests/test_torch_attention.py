"""The port's attention (contexture_nerf_tpu_torch.ops.attention) against
the JAX reference: the flash kernel in interpret mode and `_xla_attention`,
f32 on the CPU, where the port's `flash_attention` runs its plain version.
Also: the port's dispatch routes the same shapes to the kernel as the
reference routes to Pallas; a tile-by-tile emulation of the CUDA kernel
(csrc/flash_attn.cu) in bf16 matches the reference's interpret-mode kernel
and the plain version within chip_smoke.attention_limit, the limit the card
holds the kernel to, and that limit rejects the planted faults; and the
attention layer gives the same output on the strided views it now passes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ATTENTION_FAULTS, attention_limit, attention_ratio,
                        planted_attention)
from contexture_nerf_tpu.ops.attention import (_xla_attention, attention as
                                               jax_attention,
                                               flash_attention_pallas,
                                               record_attention_calls)
from contexture_nerf_tpu_torch.diffusion.layers import CrossAttention
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import attention as att

ATOL = 2e-3  # as tests/test_diffusion.py holds the interpret kernel


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


CASES = {  # (q, kv, extra) lengths at B=1, H=2, d=64
    "single": (256, 300, 0),
    "two_source": (300, 700, 600),
    "short_kv": (256, 77, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_reference(case):
    sq, skv, se = CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 1, 2, s, 64) for s in (sq, skv, skv))
    ek, ev = ((_rand(rng, 1, 2, se, 64), _rand(rng, 1, 2, se, 64)) if se
              else (None, None))
    jx = [None if a is None else jnp.asarray(a) for a in (q, k, v, ek, ev)]
    ref_kernel = np.asarray(flash_attention_pallas(*jx, interpret=True))
    kc = np.concatenate([k, ek], 2) if se else k
    vc = np.concatenate([v, ev], 2) if se else v
    ref_xla = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc)))
    tq = [None if a is None else torch.from_numpy(a) for a in (q, k, v, ek, ev)]
    before = dict(_build.launch_counts)
    out = att.flash_attention(*tq)
    routed = att.attention(*tq)
    assert _build.launch_counts == before  # CPU tensors: plain version
    for got in (out, routed):
        np.testing.assert_allclose(got.numpy(), ref_kernel, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref_xla, atol=ATOL)


ROUTE_SHAPES = [  # (Sq, Skv, Se): the main path's and the rule's edges
    (1600, 1600, 0), (9600, 9600, 0), (2400, 2400, 0), (9600, 9600, 1600),
    (2400, 2400, 400), (600, 600, 100), (400, 400, 0), (9600, 77, 0),
    (255, 2048, 0), (256, 1024, 0), (256, 1023, 0), (256, 1000, 24),
    (256, 1000, 23),
]


@pytest.mark.parametrize("sq,skv,se", ROUTE_SHAPES)
def test_dispatch_routes_as_the_reference(sq, skv, se):
    def call(q, k, v, ek, ev):
        return jax_attention(q, k, v, ek, ev, use_pallas=True)

    s = jax.ShapeDtypeStruct
    args = (s((1, 1, sq, 64), jnp.bfloat16), s((1, 1, skv, 64), jnp.bfloat16),
            s((1, 1, skv, 64), jnp.bfloat16),
            s((1, 1, se, 64), jnp.bfloat16) if se else None,
            s((1, 1, se, 64), jnp.bfloat16) if se else None)
    with record_attention_calls([]) as calls:
        jax.eval_shape(call, *args)
    assert att.routes_to_kernel(sq, skv, se) == calls[0]["pallas"]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 1, 8, 64), dtype=torch.float32)
    with pytest.raises(ValueError):
        att._check("q", q, q)  # not on a CUDA device


def emulate_kernel(q, k, v, extra_k=None, extra_v=None, bm=128,
                   bn=att.KV_TILE):
    """csrc/flash_attn.cu tile by tile in torch: BM x BN tiles, the first
    source's key tiles then the second's, each source's tail masked by its
    length, f32 scores and running max m (score units), P = exp2(s c - m c)
    rounded to bf16 before P V, O and l rescaled by exp2((m_old - m) c), O
    divided by l at the end and rounded to bf16."""
    c = 0.125 * math.log2(math.e)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    sources = [(k, v)] + ([(extra_k, extra_v)] if extra_k is not None else [])
    for i0 in range(0, q.shape[2], bm):
        qt = q[:, :, i0:i0 + bm].float()
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros(qt.shape)
        for ks, vs in sources:
            for t0 in range(0, ks.shape[2], bn):
                s = qt @ ks[:, :, t0:t0 + bn].float().transpose(-1, -2)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                a = torch.exp2((m - mx) * c)
                p = torch.exp2(s * c - mx * c)
                l = l * a + p.sum(-1, keepdim=True)
                o = o * a + p.to(torch.bfloat16).float() @ vs[
                    :, :, t0:t0 + bn].float()
                m = mx
        out[:, :, i0:i0 + bm] = (o / l).to(torch.bfloat16)
    return out


TILE_CASES = {  # (Sq, Skv, Se) at B=1, H=2: tails of 1, 16 and BN - 1 keys
    # in each source, Sq off the 128-row tile
    "tail1": (200, 129, 0),
    "tail16_127": (130, 144, 255),
    "tail127_1": (257, 255, 129),
    "short": (64, 16, 16),
}


def _bf16_inputs(sq, skv, se, seed=0):
    rng = np.random.default_rng(seed)

    def r(s):
        return torch.from_numpy(_rand(rng, 1, 2, s, 64)).to(torch.bfloat16)

    q, k, v = r(sq), r(skv), r(skv)
    ek, ev = (r(se), r(se)) if se else (None, None)
    return q, k, v, ek, ev


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_kernel_emulation_matches_reference(case):
    ins = _bf16_inputs(*TILE_CASES[case])
    emu = emulate_kernel(*ins)
    ref = torch.from_numpy(np.asarray(flash_attention_pallas(
        *[None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in ins], interpret=True)).astype(np.float32))
    plain = att.flash_attention_plain(*ins)
    for other in (ref, plain):
        limit = attention_limit(torch, *ins, other)
        assert attention_ratio(torch, emu, other, limit) <= 1.0


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_attention_limit_rejects_planted_faults(case):
    ins = _bf16_inputs(*TILE_CASES[case], seed=1)
    plain = att.flash_attention_plain(*ins)
    limit = attention_limit(torch, *ins, plain)
    caught = {}
    for fault in ATTENTION_FAULTS:
        bad = planted_attention(torch, att.flash_attention_plain, *ins, fault,
                                att.KV_TILE)
        if bad is not None:
            caught[fault] = attention_ratio(torch, bad, plain, limit) > 1.0
    assert "tail" in caught and all(caught.values()), caught


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_takes_strided_heads(dtype, monkeypatch):
    """CrossAttention passes (B, H, S, d) views of the projections, not
    copies; the output is the same as with the copies it used to make."""
    torch.manual_seed(0)
    layer = CrossAttention(320, 320, 5, 64, dtype).to(dtype)
    x = torch.randn(2, 300, 320).to(dtype)
    ref_kv = torch.randn(2, 50, 320)
    q = layer._split(layer.to_q(x))
    assert not q.is_contiguous() and q.stride(-1) == 1
    out = layer(x, ref_kv=ref_kv)
    split = CrossAttention._split
    monkeypatch.setattr(CrossAttention, "_split",
                        lambda self, t: split(self, t).contiguous())
    assert torch.equal(out, layer(x, ref_kv=ref_kv))
