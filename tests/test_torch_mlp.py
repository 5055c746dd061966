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
