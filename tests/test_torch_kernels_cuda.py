"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports neither JAX nor the JAX package, so it also runs on a machine
without them; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Point counts and sequence lengths are ragged (not multiples of the kernels'
64-row blocks) to exercise the masked tails. Tolerances: the MLP kernels and
their plain versions round every matmul operand to bf16 at the same points
and sum in f32 in other orders; a one-ulp flip cascades through the later
layers. The plain bf16 version's distance from plain f32 measures that
noise, and a kernel must stay within twice it (or 1e-3 of max|plain| where
bf16 is exact), as chip_smoke.py holds them. Attention: both versions round
P and the output to bf16 at other points, about one bf16 ulp of the largest
outputs; the kernel must stay within a tenth of the plain output's RMS, which
a dropped second KV source or a softmax scale of 1/sqrt(128) for 1/sqrt(64)
exceeds (checked here too).
"""

import pytest
import torch

from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import attention as att
from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda")


def _agrees(got, plain, plain_f32):
    err = float((got - plain).abs().max())
    noise = float((plain - plain_f32).abs().max())
    return err <= max(2.0 * noise, 1e-3 * float(plain.abs().max()))


@pytest.mark.parametrize("n", [1, 700, 5000])
def test_mlp_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    mlp = NeRF2D(generator=gen, device=cuda).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    uv = torch.rand((n, 2), generator=gen, device=cuda)
    emb = mk.pad_embedding(uv, 10, dtype=torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    for x, multires in ((emb, None), (uv, 10)):
        assert _agrees(mk.mlp_fwd_kernel(wflat, bflat, x, multires),
                       mk.fused_nerf2d_plain(ws, bs, x, multires, bf),
                       mk.fused_nerf2d_plain(ws, bs, x, multires, f32))
    g = torch.randn((n, 3), generator=gen, device=cuda)
    dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
    rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf)
    fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, f32)
    for a, b, c in zip(dws + dbs, rws + rbs, fws + fbs):
        assert _agrees(a, b, c)
    again = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs,
                                                 again[0] + again[1]))


def test_fused_entry_points_launch_the_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mlp = NeRF2D(generator=gen, device=cuda)
    uv = torch.rand((333, 2), generator=gen, device=cuda)
    before = dict(_build.launch_counts)
    mk.fused_nerf2d(mlp, uv, 10, compute_dtype=torch.bfloat16).sum().backward()
    assert _build.launch_counts["mlp_fwd"] == before["mlp_fwd"] + 1
    assert _build.launch_counts["mlp_bwd"] == before["mlp_bwd"] + 1
    assert all(torch.isfinite(p.grad).all() for p in mlp.parameters())
    with pytest.raises(ValueError, match="bf16"):
        mk.fused_nerf2d(mlp, uv, 10, compute_dtype=torch.float32)


@pytest.mark.parametrize("sq,skv,se", [(777, 1234, 0), (777, 1234, 301),
                                       (64, 64, 0), (1, 1025, 63)])
def test_flash_attention_matches_plain(cuda, sq, skv, se):
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + se)

    def rnd(s):
        return torch.randn((2, 3, s, 64), generator=gen, device=cuda,
                           dtype=torch.bfloat16)

    q, k, v = rnd(sq), rnd(skv), rnd(skv)
    ek, ev = (rnd(se), rnd(se)) if se else (None, None)
    out = att.flash_attention(q, k, v, ek, ev)
    ref = att.flash_attention_plain(q, k, v, ek, ev).float()
    tol = 0.1 * float(ref.pow(2).mean().sqrt())
    assert float((out.float() - ref).abs().max()) <= tol
    wrong_scale = att.flash_attention((q.float() * 0.5 ** 0.5).to(q.dtype),
                                      k, v, ek, ev)
    assert float((wrong_scale.float() - ref).abs().max()) > tol
    if se:
        dropped = att.flash_attention(q, k, v)
        assert float((dropped.float() - ref).abs().max()) > tol


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        att.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="64"):
        w = torch.zeros((1, 1, 8, 32), device=cuda, dtype=torch.bfloat16)
        att.flash_attention(w, w, w)
