"""The port's fused NeRF2D MLP (contexture_nerf_tpu_torch.ops.mlp_kernel)
against the JAX reference's Pallas kernel in interpret mode.

On the CPU the port's entry points run their plain versions (forward:
unfused matmuls; backward: the reference kernel's recompute-and-propagate
math inside the autograd.Function), so these tests hold the plain versions
against the reference; chip_smoke.py holds the CUDA kernels against them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.models.fields import NeRF2D as JaxNeRF2D
from contexture_nerf_tpu.models.fields import fourier_embed as jax_embed
from contexture_nerf_tpu.ops import mlp_kernel as jmk
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.models.fields import (NeRF2D, fourier_embed,
                                                     texture_from_mlp,
                                                     uv_lattice)
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

N = 700  # not a multiple of the reference's 512-point block


@pytest.fixture(scope="module")
def models():
    jmlp = JaxNeRF2D(input_ch=42)
    params = jax.jit(jmlp.init)(jax.random.PRNGKey(0), jnp.zeros((1, 42)))
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, params)))
    uv = np.random.default_rng(1).random((N, 2), dtype=np.float32)
    return jmlp, params, mlp, uv


def _jax_out(params, uv, variant, cdt):
    if variant == "uv":
        return jmk.fused_nerf2d(params, jnp.asarray(uv), 10, True, cdt)
    emb = jmk.pad_embedding(jnp.asarray(uv), 10, dtype=cdt)
    return jmk.fused_nerf2d_emb(params, emb, 10, True, cdt)


def _port_out(mlp, uv, variant, cdt):
    uv_t = torch.from_numpy(uv)
    if variant == "uv":
        return mk.fused_nerf2d(mlp, uv_t, 10, compute_dtype=cdt)
    return mk.fused_nerf2d_emb(mlp, mk.pad_embedding(uv_t, 10, dtype=cdt),
                               10, compute_dtype=cdt)


# f32: the same math, summed in another order. bf16: both round the
# operands of every matmul to bf16 at the same points and sum in f32; a sum
# that lands next to a rounding boundary can round the other way, and that
# one-ulp flip cascades through the later layers, so the bound is 2% of the
# largest output (a wrong kernel is off by O(1))
TOL = {"f32": 1e-5, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("variant", ["uv", "emb"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_reference_kernel(models, variant, dt):
    _, params, mlp, uv = models
    ref = np.asarray(_jax_out(params, uv, variant, DT[dt][0]))
    out = _port_out(mlp, uv, variant, DT[dt][1])
    assert out.shape == (N, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=TOL[dt] * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("variant", ["uv", "emb"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_matches_reference_vjp(models, variant, dt):
    _, params, mlp, uv = models

    def loss_ref(p):
        return jnp.sum(jnp.tanh(_jax_out(p, uv, variant, DT[dt][0])) ** 2)

    g_ref = weights.convert_tree(jax.tree.map(
        np.asarray, jax.grad(loss_ref)(params)))
    mlp.zero_grad(set_to_none=True)
    torch.sum(torch.tanh(_port_out(mlp, uv, variant, DT[dt][1])) ** 2
              ).backward()
    g = {k: p.grad for k, p in mlp.named_parameters()}
    assert set(g) == set(g_ref)
    for k, ref in g_ref.items():
        scale = max(float(ref.abs().max()), 1e-3)
        tol = 1e-5 if dt == "f32" else 5e-3
        np.testing.assert_allclose(g[k].numpy(), ref.numpy(),
                                   atol=tol * scale, err_msg=k)


def test_input_gets_zero_gradient(models):
    _, _, mlp, uv = models
    uv_t = torch.from_numpy(uv).requires_grad_(True)
    mk.fused_nerf2d(mlp, uv_t, 10).sum().backward()
    assert uv_t.grad is not None and not uv_t.grad.any()


def test_plain_path_on_cpu_launches_nothing(models):
    _, _, mlp, uv = models
    before = dict(_build.launch_counts)
    _port_out(mlp, uv, "emb", torch.bfloat16).sum()
    assert _build.launch_counts == before


def test_fields_match_reference(models):
    """fourier_embed ordering, the NeRF2D module (skip as [emb, h]), the UV
    lattice and the texture query."""
    jmlp, params, mlp, uv = models
    np.testing.assert_allclose(
        fourier_embed(torch.from_numpy(uv)).numpy(),
        np.asarray(jax_embed(jnp.asarray(uv))), atol=1e-6)
    emb = np.array(jax_embed(jnp.asarray(uv)))
    np.testing.assert_allclose(
        mlp(torch.from_numpy(emb)).detach().numpy(),
        np.asarray(jmlp.apply(params, emb)), atol=1e-5)
    from contexture_nerf_tpu.models.fields import uv_lattice as jax_lattice
    from contexture_nerf_tpu.models.fields import \
        texture_from_mlp as jax_texture

    np.testing.assert_allclose(uv_lattice(7, device="cpu").numpy(),
                               np.asarray(jax_lattice(7)), atol=1e-7)
    tex, raw = texture_from_mlp(mlp, 16)
    jtex, jraw = jax_texture(jmlp, params, 16, use_fused=False)
    assert tuple(tex.shape) == (1, 3, 16, 16)
    np.testing.assert_allclose(tex.detach().numpy(), np.asarray(jtex),
                               atol=5e-5)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(models):
    _, _, mlp, uv = models
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        mk.mlp_fwd_kernel(wflat, bflat, torch.from_numpy(uv), 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)
    emb = mk.pad_embedding(torch.from_numpy(uv), 10, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        mk.mlp_fwd_kernel(wflat, bflat, emb, None)
    # K2: g's shape and type, at least one point, TMA's 16-byte alignment
    # of the embedding, and the card
    emb = mk.pad_embedding(torch.from_numpy(uv), 10, dtype=torch.bfloat16)
    g = torch.zeros((N, 3))
    for bad in (g[:, :2].contiguous(), g.double(), g[:-1]):
        with pytest.raises(ValueError, match="g must be"):
            mk.mlp_bwd_kernel(wflat, bflat, emb, bad, None)
    with pytest.raises(ValueError, match="no points"):
        mk.mlp_bwd_kernel(wflat, bflat, emb[:0], g[:0], None)
    flat = torch.zeros(N * mk.EMB_PAD + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(N, mk.EMB_PAD)
    with pytest.raises(ValueError, match="16-byte"):
        mk.mlp_bwd_kernel(wflat, bflat, shifted, g, None)
    with pytest.raises(ValueError, match="wt must be"):
        mk.mlp_bwd_kernel(wflat, bflat, emb, g, None,
                          torch.zeros((mk.DELTA_ROWS, mk.W - 1),
                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one card"):
        mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
    with pytest.raises(ValueError, match="bf16"):
        mk.mlp_bwd_kernel(*mk.flatten_params(ws, bs, torch.float32), emb, g,
                          None)


def emulate_fwd_kernel(ws, bs, x, multires, tile=512):
    """csrc/mlp_fwd.cu in torch, tile by tile (a cluster of four 128-point
    CTAs): the embedding rounded to bf16; each hidden layer's f32
    accumulator built one 16-row weight slab at a time in the order the
    producer streams them (layer 5: the embedding's 3 slabs, then h4's 16),
    each slab's product summed in f32 and added to the accumulator; bias
    and ReLU in f32, then bf16 for the next layer; the output layer's 3
    columns as each thread of a quad sums its 32 activations of a row
    (fragment registers in order, two products each), the quad's sums added
    by xor shuffles (1, then 2), then the bias. ws, bs packed f32."""
    bf = torch.bfloat16
    emb = mk._input_embedding(x, multires).to(bf).float()
    w = [wi.to(bf).float() for wi in ws]
    out = torch.empty((x.shape[0], 3))
    for r0 in range(0, x.shape[0], tile):
        e = emb[r0:r0 + tile]
        h = e
        for i in range(mk.DEPTH):
            a = torch.cat([e, h], -1) if i == mk.SKIP + 1 else h
            acc = torch.zeros((a.shape[0], mk.W))
            for k in range(0, a.shape[1], 16):
                acc = acc + a[:, k:k + 16] @ w[i][k:k + 16]
            h = torch.relu(acc + bs[i]).to(bf).float()
        quads = []
        for t in range(4):
            o = torch.zeros((h.shape[0], 3))
            for kk in range(16):
                for k in (16 * kk + 2 * t, 16 * kk + 2 * t + 8):
                    o = (o + h[:, k:k + 1] * w[mk.DEPTH][k, :3]) \
                        + h[:, k + 1:k + 2] * w[mk.DEPTH][k + 1, :3]
            quads.append(o)
        s = [quads[t] + quads[t ^ 1] for t in range(4)]
        out[r0:r0 + tile] = (s[0] + s[2]) + bs[mk.DEPTH][:3]
    return out


@pytest.mark.parametrize("variant", ["uv", "emb"])
def test_emulated_fwd_kernel_matches_reference_and_plain(models, variant):
    """The CUDA kernel's schedule, emulated on the CPU, against the JAX
    kernel in interpret mode (TOL["bf16"], as the port's plain path is
    held) and against the plain bf16 version within chip_smoke.mlp_tol,
    the limit the card holds K1 to (2x the plain bf16 version's distance
    from plain f32)."""
    from chip_smoke import mlp_tol

    _, params, mlp, uv = models
    ps = [p.detach() for lin in mlp.linears() for p in (lin.weight,
                                                         lin.bias)]
    ws, bs = mk.pack_params(ps, 10)
    uv_t = torch.from_numpy(uv)
    x, mr = ((uv_t, 10) if variant == "uv" else
             (mk.pad_embedding(uv_t, 10, dtype=torch.bfloat16), None))
    got = emulate_fwd_kernel(ws, bs, x, mr)
    ref = np.asarray(_jax_out(params, uv, variant, jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL["bf16"] * max(1.0, np.abs(ref).max()))
    plain = mk.fused_nerf2d_plain(ws, bs, x, mr, torch.bfloat16)
    tol, _ = mlp_tol(plain, mk.fused_nerf2d_plain(ws, bs, x, mr,
                                                  torch.float32))
    assert float((got - plain).abs().max()) <= tol


def emulate_bwd_kernel(ws, bs, x, g, multires, sms=132):
    """K2's two-phase schedule in torch, on the card's plan (csrc/mlp_fwd.cu's
    FWD_ACTS and DELTA instantiations, then csrc/mlp_bwd.cu).
    Phase A: the forward recomputed with bf16 operands and f32 sums into a
    bf16 act buffer (act_1..act_8); delta_7 = bf16(g) W_8^T and delta_{i-1}
    = bf16(delta_i) W_i^T (h4's rows of W_5 at the skip) in f32, masked by
    act > 0, stored bf16 into the delta buffer; db from the f32 deltas, a
    column sum per 64-point warpgroup block, each warpgroup's blocks added
    tile by tile into its partial, the partials added in order. Phase B:
    dW_l = A_l^T bf16(Delta_l) summed per 64-point k-step within each of
    the plan's chunks, the chunks' f32 partials added in chunk order; dW_8
    = act_8^T bf16(g) per OUT_CHUNK-point chunk, in chunk order. ws, bs
    packed f32; returns padded (dws, dbs) f32."""
    bf = torch.bfloat16
    n = x.shape[0]
    emb = mk._input_embedding(x, multires).to(bf).float()
    w = [wi.to(bf).float() for wi in ws]
    acts, h = [], emb
    for i in range(mk.DEPTH):
        a = torch.cat([emb, h], -1) if i == mk.SKIP + 1 else h
        h = torch.relu(a @ w[i] + bs[i]).to(bf).float()
        acts.append(h)
    gp = torch.nn.functional.pad(g.float(), (0, mk.OUT_PAD - 3))
    gb = gp.to(bf).float()
    deltas = [None] * mk.DEPTH
    d = (gb @ w[mk.DEPTH].t()) * (acts[mk.DEPTH - 1] > 0)
    deltas[mk.DEPTH - 1] = d
    for i in range(mk.DEPTH - 1, 0, -1):
        wt = w[i][mk.EMB_PAD:] if i == mk.SKIP + 1 else w[i]
        d = (d.to(bf).float() @ wt.t()) * (acts[i - 1] > 0)
        deltas[i - 1] = d
    # db: one partial a consumer warpgroup of the persistent grid (clusters
    # of 4 CTAs of 2 warpgroups, 512-point tiles, cluster k taking tiles k,
    # k + C, ...), its 64-row blocks' column sums added tile by tile; the
    # partials added in warpgroup order
    ntiles = -(-n // 512)
    clusters = max(1, min(ntiles, sms // 4))
    cols = [gp] + [deltas[i] for i in range(mk.DEPTH - 1, -1, -1)]
    layers = [mk.DEPTH] + list(range(mk.DEPTH - 1, -1, -1))
    dbs = [torch.zeros(mk.LAYER_N[i]) for i in range(mk.DEPTH + 1)]
    for k in range(clusters):
        for r0 in range(0, 512, 64):  # rank, then warpgroup
            part = [torch.zeros(mk.LAYER_N[i]) for i in range(mk.DEPTH + 1)]
            for t in range(k, ntiles, clusters):
                p0 = t * 512 + r0
                for layer, col in zip(layers, cols):
                    part[layer] = part[layer] + col[p0:p0 + 64].sum(0)
            dbs = [a + p for a, p in zip(dbs, part)]
    plan = mk.dw_plan(n, sms)
    span = plan["steps"] * mk.KSTEP
    ins = [emb] + [torch.cat([emb, acts[i - 1]], -1) if i == mk.SKIP + 1
                   else acts[i - 1] for i in range(1, mk.DEPTH)]
    dws = [torch.zeros(mk.LAYER_K[i], mk.LAYER_N[i])
           for i in range(mk.DEPTH + 1)]
    for c in range(plan["chunks"]):
        part = [torch.zeros_like(t) for t in dws[:mk.DEPTH]]
        for p0 in range(c * span, min((c + 1) * span, n), mk.KSTEP):
            for i in range(mk.DEPTH):
                dl = deltas[i][p0:p0 + mk.KSTEP].to(bf).float()
                part[i] = part[i] + ins[i][p0:p0 + mk.KSTEP].t() @ dl
        dws[:mk.DEPTH] = [a + p for a, p in zip(dws, part)]
    for p0 in range(0, n, mk.OUT_CHUNK):
        q = slice(p0, p0 + mk.OUT_CHUNK)
        dws[mk.DEPTH] = dws[mk.DEPTH] + acts[mk.DEPTH - 1][q].t() @ gb[q]
    return dws, dbs


@pytest.mark.parametrize("variant", ["uv", "emb"])
def test_emulated_bwd_kernel_matches_reference_and_plain(models, variant):
    """K2's two-phase schedule, emulated on the CPU, against the JAX VJP
    with `_bwd_kernel` in interpret mode (5e-3 of each gradient's largest
    entry, the bf16 bound of test_backward_matches_reference_vjp) and
    against the plain bf16 version within chip_smoke.mlp_tol, the limit the
    card holds K2 to."""
    from chip_smoke import mlp_tol

    _, params, mlp, uv = models

    def loss_ref(p):
        return jnp.sum(jnp.tanh(_jax_out(p, uv, variant, jnp.bfloat16)) ** 2)

    g_ref = weights.convert_tree(jax.tree.map(
        np.asarray, jax.grad(loss_ref)(params)))
    ps = [p.detach() for lin in mlp.linears() for p in (lin.weight,
                                                         lin.bias)]
    ws, bs = mk.pack_params(ps, 10)
    uv_t = torch.from_numpy(uv)
    x, mr = ((uv_t, 10) if variant == "uv" else
             (mk.pad_embedding(uv_t, 10, dtype=torch.bfloat16), None))
    out = mk.fused_nerf2d_plain(ws, bs, x, mr, torch.bfloat16)
    t = torch.tanh(out)
    g = 2 * t * (1 - t * t)
    dws, dbs = emulate_bwd_kernel(ws, bs, x, g, mr)
    grads = mk.unpack_grads(dws, dbs, 10)
    keys = [k for k, _ in mlp.named_parameters()]
    assert len(keys) == len(grads)
    for k, got in zip(keys, grads):
        ref = g_ref[k]
        scale = max(float(ref.abs().max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=5e-3 * scale, err_msg=k)
    rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, mr, torch.bfloat16)
    fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, mr, torch.float32)
    for i, (a, b, c) in enumerate(zip(dws + dbs, rws + rbs, fws + fbs)):
        tol, _ = mlp_tol(b, c)
        assert float((a - b).abs().max()) <= tol, i


@pytest.mark.parametrize("fault", [None, "relu6_mask", "skip_offset",
                                   "dropped_chunk"])
def test_frobenius_limit_holds_k2_and_misses_planted_faults(fault):
    """At 4,096 points (a step of fit_texture_to_image) the emulated K2
    stays within chip_smoke.fro_tol on every gradient (relative Frobenius
    error within half the plain bf16 version's distance from plain f32),
    and each planted fault misses it on at least one: a K2 that leaves one
    of its dW plan's point chunks out of the sum can pass mlp_tol's max abs
    limit at this count, and this limit is what catches it on the card."""
    from chip_smoke import fro_tol, planted_mlp, rel_fro

    n = 4096
    gen = torch.Generator().manual_seed(4)
    mlp = NeRF2D(generator=gen, device="cpu")
    ps = [p.detach() for lin in mlp.linears() for p in (lin.weight,
                                                         lin.bias)]
    ws, bs = mk.pack_params(ps, 10)
    uv = torch.rand((n, 2), generator=gen)
    g = torch.randn((n, 3), generator=gen) * 1e-2
    rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, uv, g, 10, torch.bfloat16)
    fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, uv, g, 10, torch.float32)
    if fault is None:
        dws, dbs = emulate_bwd_kernel(ws, bs, uv, g, 10)
    else:
        _, dws, dbs = planted_mlp(torch, ws, bs, mk.embed_block(uv, 10), g,
                                  fault)
    ratio = max(rel_fro(a, b) / fro_tol(b, c)[0]
                for a, b, c in zip(dws + dbs, rws + rbs, fws + fbs))
    assert (ratio <= 1) if fault is None else (ratio > 1), ratio


@pytest.mark.parametrize("n", [1, 1000, 4096, 200704, 614400, 1048576])
def test_dw_work_plan_covers_every_weight_row_and_point_once(n):
    """Phase B's units (row block, point chunk) cover every (layer, weight
    row, point) of dW_0..dW_7 exactly once; layers 0 and 5 have a 48-row
    embedding block; the grid is whole waves of an H100's 132 SMs. At
    4,096 points (a step of fit_texture_to_image) the last of the 33
    chunks holds no point: its units write zero partials."""
    blocks = mk.dw_row_blocks()
    plan = mk.dw_plan(n, 132)
    assert plan["grid"] == len(blocks) * plan["chunks"]
    assert plan["grid"] % 132 == 0
    emb_blocks = [(l, r0, rows) for l, a, r0, rows in blocks if a < 0]
    assert emb_blocks == [(0, 0, mk.EMB_PAD), (mk.SKIP + 1, 0, mk.EMB_PAD)]
    for layer in range(mk.DEPTH):
        rows = np.zeros(mk.LAYER_K[layer], int)
        for l, acol, r0, nr in blocks:
            if l != layer:
                continue
            rows[r0:r0 + nr] += 1
            if acol >= 0:  # hidden rows read act_layer's own columns
                hid = r0 - (mk.EMB_PAD if layer == mk.SKIP + 1 else 0)
                assert acol == (layer - 1) * mk.W + hid and nr == 128
        assert (rows == 1).all(), layer
    pts = np.zeros(n, int)
    span = plan["steps"] * mk.KSTEP
    for c in range(plan["chunks"]):
        pts[c * span:min((c + 1) * span, n)] += 1
    assert (pts == 1).all()
    assert plan["steps"] * plan["chunks"] >= plan["ksteps"] == -(-n // 64)


def test_transposed_stack_matches_pack_params(models):
    """K2's delta-pass weights: W_8^T (its 3 real rows, then zeros), then
    W_7^T .. W_1^T with layer 5 cut to h4's rows, each the bf16 of the
    torch layout's (out, in) weight, which is already W^T."""
    _, _, mlp, _ = models
    ps = [p.detach() for lin in mlp.linears() for p in (lin.weight,
                                                         lin.bias)]
    ws, bs = mk.pack_params(ps, 10)
    wt = mk.transposed_stack(mk.flatten_params(ws, bs, torch.bfloat16)[0])
    bf = torch.bfloat16
    assert wt.shape == (mk.DELTA_ROWS, mk.W) == (1808, 256)
    assert wt.dtype == bf and wt.is_contiguous()
    assert torch.equal(wt[:3], ps[2 * mk.DEPTH].to(bf))
    assert not wt[3:16].any()
    r = 16
    for i in range(mk.DEPTH - 1, 0, -1):
        w = ps[2 * i]  # (256 out, in)
        want = w[:, 42:] if i == mk.SKIP + 1 else w  # h4's inputs at the skip
        assert torch.equal(wt[r:r + mk.W], want.to(bf)), i
        assert torch.equal(wt[r:r + mk.W],
                           (ws[i][mk.EMB_PAD:] if i == mk.SKIP + 1
                            else ws[i]).t().to(bf)), i
        r += mk.W
    assert r == mk.DELTA_ROWS
