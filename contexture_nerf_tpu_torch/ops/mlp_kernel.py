"""Fused Fourier-embed + NeRF2D MLP: CUDA kernels (forward, backward) and
their plain PyTorch versions.

Counterpart of contexture_nerf_tpu/ops/mlp_kernel.py (`_fwd_kernel`,
`_bwd_kernel`). Kernels: csrc/mlp_fwd.cu (K1) and csrc/mlp_bwd.cu (K2).

Layout shared by the kernels and the plain versions ("packed" params):
  - the 42-dim embedding is zero-padded to EMB_PAD = 48, a multiple of the
    16-deep bf16 tensor-core step (the JAX package padded to 128, a TPU lane
    width); the padded weight rows are zero, so the pad is exact;
  - layer i weight is (K_i, N_i), row-major, the flax (in, out) layout:
    K = 48, 256 x4, 48 + 256 (the [emb, h] skip input), 256 x2; the output
    layer is (256, 16) with its 3 real columns first;
  - weights in the compute dtype, biases in f32; matmuls take compute-dtype
    operands and accumulate in f32; activations are cast to the compute
    dtype at each matmul, as the reference kernel does.

`fused_nerf2d` (uv in, embedding computed in the kernel) and
`fused_nerf2d_emb` (precomputed embedding from `pad_embedding`) are
differentiable w.r.t. the MLP parameters through one autograd.Function; the
gradient w.r.t. uv/emb is zero, as in the reference. A CUDA tensor launches
the kernels (bf16 compute only) or raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from contexture_nerf_tpu_torch.ops import _build

EMB_PAD = 48
W = 256
SKIP = 4
DEPTH = 8
OUT_PAD = 16
LAYER_K = [EMB_PAD, W, W, W, W, EMB_PAD + W, W, W, W]
LAYER_N = [W] * DEPTH + [OUT_PAD]
W_NUMEL = sum(k * n for k, n in zip(LAYER_K, LAYER_N))
B_NUMEL = sum(LAYER_N)


def _emb_dim(multires: int) -> int:
    return 2 + 4 * multires


def embed_block(uv: torch.Tensor, multires: int) -> torch.Tensor:
    """(N, 2) uv -> (N, EMB_PAD) f32 embedding, zero-padded:
    [uv, sin(1 uv), cos(1 uv), sin(2 uv), ...]."""
    uv = uv.float()
    outs = [uv]
    for i in range(multires):
        f = float(2.0 ** i)
        outs.append(torch.sin(uv * f))
        outs.append(torch.cos(uv * f))
    emb = torch.cat(outs, dim=-1)
    return torch.nn.functional.pad(emb, (0, EMB_PAD - emb.shape[-1]))


def pad_embedding(uv: torch.Tensor, multires: int = 10,
                  dtype=torch.float32) -> torch.Tensor:
    """Precomputed padded embedding (N, EMB_PAD) for `fused_nerf2d_emb`;
    sin/cos in f32, stored in `dtype` (the compute dtype: the kernel casts
    to it at every matmul anyway)."""
    return embed_block(uv, multires).to(dtype).contiguous()


# -- packing -----------------------------------------------------------------

def pack_params(params: List[torch.Tensor], multires: int
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """NeRF2D parameters [w0, b0, ..., w8, b8] in torch layout ((out, in))
    -> padded f32 (ws (K_i, N_i), bs (N_i,)) lists."""
    e = _emb_dim(multires)
    ws, bs = [], []
    for i in range(DEPTH + 1):
        w = params[2 * i].float().t()
        b = params[2 * i + 1].float()
        if i == 0:
            w = torch.nn.functional.pad(w, (0, 0, 0, EMB_PAD - e))
        elif i == SKIP + 1:
            w = torch.cat([w[:e], w.new_zeros(EMB_PAD - e, W), w[e:]], dim=0)
        elif i == DEPTH:
            w = torch.nn.functional.pad(w, (0, OUT_PAD - w.shape[1]))
            b = torch.nn.functional.pad(b, (0, OUT_PAD - b.shape[0]))
        ws.append(w)
        bs.append(b)
    return ws, bs


def unpack_grads(dws: List[torch.Tensor], dbs: List[torch.Tensor],
                 multires: int) -> List[torch.Tensor]:
    """Padded (dws, dbs) -> gradients in the torch parameter layout."""
    e = _emb_dim(multires)
    out = []
    for i in range(DEPTH + 1):
        dw, db = dws[i], dbs[i]
        if i == 0:
            dw = dw[:e]
        elif i == SKIP + 1:
            dw = torch.cat([dw[:e], dw[EMB_PAD:]], dim=0)
        elif i == DEPTH:
            dw, db = dw[:, :3], db[:3]
        out += [dw.t().contiguous(), db.contiguous()]
    return out


def flatten_params(ws, bs, compute_dtype):
    """Kernel buffers: all weights in one (W_NUMEL,) compute-dtype buffer,
    all biases in one (B_NUMEL,) f32 buffer, layer after layer."""
    wflat = torch.cat([w.reshape(-1) for w in ws]).to(compute_dtype)
    bflat = torch.cat([b.reshape(-1) for b in bs]).float()
    return wflat.contiguous(), bflat.contiguous()


def split_flat(wflat: torch.Tensor, bflat: torch.Tensor):
    ws, bs, ow, ob = [], [], 0, 0
    for k, n in zip(LAYER_K, LAYER_N):
        ws.append(wflat[ow:ow + k * n].reshape(k, n))
        bs.append(bflat[ob:ob + n])
        ow += k * n
        ob += n
    return ws, bs


# -- plain versions ------------------------------------------------------------

def _dot(a, b, cdt):
    """Compute-dtype operands, f32 accumulation (bf16 values are exact in
    f32, so an f32 product of the rounded operands is the tensor-core sum)."""
    if cdt != torch.float32:
        a = a.to(cdt).float()
        b = b.to(cdt).float()
    return a @ b


def _input_embedding(x, multires):
    return embed_block(x, multires) if multires is not None else x.float()


def fused_nerf2d_plain(ws, bs, x, multires, compute_dtype):
    """Plain forward: unfused matmuls. x is uv (N, 2) when multires is
    given, else the padded embedding (N, EMB_PAD). Returns (N, 3) f32."""
    emb = _input_embedding(x, multires)
    h = emb
    for i in range(DEPTH):
        h = torch.relu(_dot(h, ws[i], compute_dtype) + bs[i])
        if i == SKIP:
            h = torch.cat([emb, h], dim=-1)
    out = _dot(h, ws[DEPTH], compute_dtype) + bs[DEPTH]
    return out[:, :3]


def fused_nerf2d_bwd_plain(ws, bs, x, g, multires, compute_dtype):
    """Plain backward of the same function, the reference kernel's math:
    recompute the activations, back-propagate through the ReLU masks and the
    skip split, dW = h_in^T delta (compute-dtype operands, f32 sums), db = f32
    column sums of delta. g (N, 3) f32. Returns padded (dws, dbs) f32."""
    cdt = compute_dtype
    emb = _input_embedding(x, multires)
    acts = [emb]
    h = emb
    for i in range(DEPTH):
        h = torch.relu(_dot(h, ws[i], cdt) + bs[i])
        if i == SKIP:
            h = torch.cat([emb, h], dim=-1)
        acts.append(h)
    gp = torch.nn.functional.pad(g.float(), (0, OUT_PAD - g.shape[1]))
    dws = [None] * (DEPTH + 1)
    dbs = [None] * (DEPTH + 1)
    dws[DEPTH] = _dot(acts[DEPTH].t(), gp, cdt)
    dbs[DEPTH] = gp.sum(0)
    delta = _dot(gp, ws[DEPTH].t(), cdt)
    for i in range(DEPTH - 1, -1, -1):
        h_out = acts[i + 1]
        if i == SKIP:
            h_out = h_out[:, EMB_PAD:]
            delta = delta[:, EMB_PAD:]
        delta = delta * (h_out > 0).float()
        dws[i] = _dot(acts[i].t(), delta, cdt)
        dbs[i] = delta.sum(0)
        if i > 0:
            delta = _dot(delta, ws[i].t(), cdt)
    return dws, dbs


# -- kernels -------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib_fwd():
    lib = _build.library("mlp_fwd")
    lib.mlp_fwd.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P]
    lib.mlp_fwd.restype = _I
    return lib


def _lib_bwd():
    lib = _build.library("mlp_bwd")
    lib.mlp_bwd.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P]
    lib.mlp_bwd.restype = _I
    lib.mlp_bwd_reduce.argtypes = [_P, _P, _I, _I, _P]
    lib.mlp_bwd_reduce.restype = _I
    return lib


def _check_kernel_inputs(x, multires, compute_dtype):
    if compute_dtype != torch.bfloat16:
        raise ValueError("the MLP kernels compute in bf16; got "
                         f"compute_dtype={compute_dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D tensor")
    if multires is not None:
        if x.shape[1] != 2 or x.dtype != torch.float32:
            raise ValueError("uv must be (N, 2) float32")
        if _emb_dim(multires) > EMB_PAD:
            raise ValueError(f"multires={multires} exceeds EMB_PAD={EMB_PAD}")
    elif x.shape[1] != EMB_PAD or x.dtype != torch.bfloat16:
        raise ValueError(f"emb must be (N, {EMB_PAD}) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    # the kernels index rows with int (element offsets are 64-bit)
    if x.shape[0] > 2 ** 31 - 1 - 64:
        raise ValueError("too many points for int32 row indices")


def mlp_fwd_kernel(wflat, bflat, x, multires):
    """K1: (N, 3) f32 MLP output from uv (multires given) or the padded
    embedding, with flattened bf16 weights and f32 biases."""
    _check_kernel_inputs(x, multires, wflat.dtype)
    if wflat.numel() != W_NUMEL or bflat.numel() != B_NUMEL \
            or bflat.dtype != torch.float32 or not x.is_cuda \
            or wflat.device != x.device or bflat.device != x.device:
        raise ValueError("packed weights/biases do not match the kernel")
    n = x.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    lib = _lib_fwd()
    err = lib.mlp_fwd(x.data_ptr(), int(multires is not None),
                      int(multires or 0), wflat.data_ptr(), bflat.data_ptr(),
                      out.data_ptr(), n, _build.stream_ptr(x.device))
    _build.check(err, "mlp_fwd")
    _build.launch_counts["mlp_fwd"] += 1
    return out


# rows per CTA block in mlp_bwd.cu; its per-CTA activation scratch holds
# DEPTH activations of BLOCK x W bf16
_BWD_BLOCK = 64


def mlp_bwd_kernel(wflat, bflat, x, g, multires):
    """K2: padded (dws, dbs) f32 from the same inputs as K1 and g (N, 3)
    f32. Each CTA sums its blocks into its own f32 partial; a second kernel
    adds the partials in CTA order, so two runs are bit-identical."""
    _check_kernel_inputs(x, multires, wflat.dtype)
    n = x.shape[0]
    if g.shape != (n, 3) or g.dtype != torch.float32 \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError("g must be contiguous (N, 3) float32 on x's device")
    if wflat.numel() != W_NUMEL or bflat.numel() != B_NUMEL:
        raise ValueError("packed weights/biases do not match the kernel")
    props = torch.cuda.get_device_properties(x.device)
    nblocks = -(-n // _BWD_BLOCK)
    grid = max(1, min(props.multi_processor_count, nblocks))
    scratch = torch.empty((grid, DEPTH, _BWD_BLOCK, W), dtype=torch.bfloat16,
                          device=x.device)
    partial = torch.empty((grid, W_NUMEL + B_NUMEL), dtype=torch.float32,
                          device=x.device)
    total = torch.empty((W_NUMEL + B_NUMEL,), dtype=torch.float32,
                        device=x.device)
    lib = _lib_bwd()
    stream = _build.stream_ptr(x.device)
    err = lib.mlp_bwd(x.data_ptr(), int(multires is not None),
                      int(multires or 0), g.data_ptr(), wflat.data_ptr(),
                      bflat.data_ptr(), scratch.data_ptr(),
                      partial.data_ptr(), n, grid, stream)
    _build.check(err, "mlp_bwd")
    err = lib.mlp_bwd_reduce(partial.data_ptr(), total.data_ptr(),
                             W_NUMEL + B_NUMEL, grid, stream)
    _build.check(err, "mlp_bwd_reduce")
    _build.launch_counts["mlp_bwd"] += 1
    return split_flat(total[:W_NUMEL], total[W_NUMEL:])


# -- autograd entry points -------------------------------------------------------

class _FusedNeRF2D(torch.autograd.Function):
    """Packs the parameters once in the forward; on the card the flattened
    kernel buffers stay in ctx for K2."""

    @staticmethod
    def forward(ctx, x, multires, emb_multires, cdt, *params):
        ctx.multires, ctx.emb_multires, ctx.cdt = multires, emb_multires, cdt
        ctx.save_for_backward(x, *params)
        ws, bs = pack_params(params, emb_multires)
        if x.is_cuda:
            ctx.flat = flatten_params(ws, bs, cdt)
            return mlp_fwd_kernel(*ctx.flat, x, multires)
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        ctx.packed = (ws, bs)
        return fused_nerf2d_plain(ws, bs, x, multires, cdt)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        g = g.float().contiguous()
        if x.is_cuda:
            dws, dbs = mlp_bwd_kernel(*ctx.flat, x, g, ctx.multires)
        else:
            dws, dbs = fused_nerf2d_bwd_plain(*ctx.packed, x, g, ctx.multires,
                                              ctx.cdt)
        grads = unpack_grads(dws, dbs, ctx.emb_multires)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return (dx, None, None, None,
                *[gr.to(p.dtype) for gr, p in zip(grads, params)])


def _params_of(mlp) -> List[torch.Tensor]:
    out = []
    for lin in mlp.linears():
        out += [lin.weight, lin.bias]
    return out


def fused_nerf2d(mlp, uv: torch.Tensor, multires: int = 10,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Fused embed + MLP: NeRF2D module, uv (N, 2) -> raw output (N, 3) f32,
    differentiable w.r.t. the module's parameters."""
    return _FusedNeRF2D.apply(uv, multires, multires, compute_dtype,
                              *_params_of(mlp))


def fused_nerf2d_emb(mlp, emb: torch.Tensor, multires: int = 10,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """`fused_nerf2d` on a precomputed embedding (N, EMB_PAD) from
    `pad_embedding`; multires sets how parameter gradients are unpadded."""
    return _FusedNeRF2D.apply(emb, None, multires, compute_dtype,
                              *_params_of(mlp))
