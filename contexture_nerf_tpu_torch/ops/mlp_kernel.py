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
import math
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


def embedder_out_dim(multires: int = 10, input_dims: int = 2,
                     include_input: bool = True) -> int:
    """Width of the Fourier embedding: input_dims * (include_input +
    2 multires); 42 for the texture field's uv at multires 10."""
    return input_dims * (int(include_input) + 2 * multires)


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
    e = embedder_out_dim(multires)
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
    e = embedder_out_dim(multires)
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


def transposed_stack(wflat: torch.Tensor) -> torch.Tensor:
    """K2's delta-pass weights from the flat packed weights: the rows
    [W_8^T (16 x 256); W_7^T; W_6^T; W_5[EMB_PAD:]^T (h4's rows, the only
    ones that carry delta back); W_4^T; W_3^T; W_2^T; W_1^T], (1808, 256)
    row-major, so that B = W_l^T is N-major as K1's weights are."""
    offs = [0]
    for k, n in zip(LAYER_K, LAYER_N):
        offs.append(offs[-1] + k * n)

    def w(i):
        return wflat[offs[i]:offs[i + 1]].view(LAYER_K[i], LAYER_N[i])

    rows = [w(DEPTH).t()] + [(w(i)[EMB_PAD:] if i == SKIP + 1 else w(i)).t()
                             for i in range(DEPTH - 1, 0, -1)]
    return torch.cat(rows).contiguous()


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
    lib.mlp_fwd_acts.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I, _P]
    lib.mlp_fwd_acts.restype = _I
    lib.mlp_delta.argtypes = [_P, _P, _P, _P, _P, _I,
                              ctypes.POINTER(ctypes.c_int), _P]
    lib.mlp_delta.restype = _I
    return lib


def _lib_bwd():
    lib = _build.library("mlp_bwd")
    lib.mlp_bwd_dw.argtypes = [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_int),
                               _I, _I, _I, _P]
    lib.mlp_bwd_dw_out.argtypes = [_P, _P, _P, _I, _P]
    lib.mlp_bwd_reduce.argtypes = [_P, _P, _I, _I, _P]
    for f in (lib.mlp_bwd_dw, lib.mlp_bwd_dw_out, lib.mlp_bwd_reduce):
        f.restype = _I
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
        if embedder_out_dim(multires) > EMB_PAD:
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
    _build.count_launch("mlp_fwd", n)
    return out


# K2's two phases (csrc/mlp_bwd.cu): phase A writes every point's bf16
# activations act_1..act_8 and deltas delta_0..delta_7 into two (N, ACTS_LD)
# buffers (column block l: the output of hidden layer l, the delta at its
# input); phase B sums dW_l = A_l^T Delta_l over chunks of KSTEP-point steps
ACTS_LD = DEPTH * W
HIDDEN_NUMEL = sum(k * n for k, n in zip(LAYER_K[:DEPTH], LAYER_N[:DEPTH]))
DELTA_ROWS = OUT_PAD + (DEPTH - 1) * W  # rows of the transposed stack
KSTEP = 64       # points a phase-B k-step
OUT_CHUNK = 256  # points a dW_8 partial


def dw_row_blocks() -> List[Tuple[int, int, int, int]]:
    """Phase B's 16 row blocks of dW_0..dW_7, the table mlp_bwd.cu's dW
    pass takes: (layer, act-buffer column of the first feature or -1 for
    the embedding, first dW row, rows). Layers 0 and 5 have one 48-row
    embedding block; each layer's hidden rows come in two 128-row
    blocks."""
    out = [(0, -1, 0, EMB_PAD)]
    for layer in range(1, DEPTH):
        if layer == SKIP + 1:
            out.append((layer, -1, 0, EMB_PAD))
        r0 = EMB_PAD if layer == SKIP + 1 else 0
        out += [(layer, (layer - 1) * W + 128 * h, r0 + 128 * h, 128)
                for h in range(2)]
    return out


_DW_BLOCKS = dw_row_blocks()


def dw_plan(n: int, sms: int) -> dict:
    """Phase B's grid for n points on a card of `sms` SMs: 16 row blocks
    times `chunks` point chunks of `steps` k-steps each, the chunk count
    the least that makes the grid whole waves of `sms` (one CTA an SM)."""
    rb = len(_DW_BLOCKS)
    chunks = math.lcm(rb, sms) // rb
    ksteps = -(-n // KSTEP)
    steps = max(1, -(-ksteps // chunks))
    return {"chunks": chunks, "steps": steps, "ksteps": ksteps,
            "grid": rb * chunks}


def mlp_bwd_kernel(wflat, bflat, x, g, multires, wt=None):
    """K2: padded (dws, dbs) f32 from the same inputs as K1 and g (N, 3)
    f32, in two phases (csrc/mlp_bwd.cu): phase A recomputes the forward
    through K1's STORE_ACTS instantiation into the bf16 activation buffer,
    then K1's DELTA instantiation runs over `wt` (`transposed_stack(wflat)`,
    packed here when not given) into the bf16 delta buffer and per-
    warpgroup db partials; phase B sums dW per point chunk with wgmma and
    dW_8 per 256 points; the partials are added in chunk (warpgroup)
    order, so two runs are bit-identical."""
    _check_kernel_inputs(x, multires, wflat.dtype)
    n = x.shape[0]
    if g.shape != (n, 3) or g.dtype != torch.float32 \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError("g must be contiguous (N, 3) float32 on x's device")
    if wflat.numel() != W_NUMEL or bflat.numel() != B_NUMEL:
        raise ValueError("packed weights/biases do not match the kernel")
    if n == 0:
        raise ValueError("no points")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (TMA)")
    if wt is None:
        wt = transposed_stack(wflat)
    if wt.shape != (DELTA_ROWS, W) or wt.dtype != torch.bfloat16 \
            or not wt.is_contiguous():
        raise ValueError("wt must be the contiguous (1808, 256) bf16 "
                         "transposed stack")
    if not x.is_cuda or any(t.device != x.device for t in (wflat, bflat, wt)):
        raise ValueError("x, g and the packed weights must lie on one card")
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dw_plan(n, sms)
    bf, f32 = torch.bfloat16, torch.float32
    acts = torch.empty((n, ACTS_LD), dtype=bf, device=dev)
    deltas = torch.empty((n, ACTS_LD), dtype=bf, device=dev)
    emb = x if multires is None else torch.empty((n, EMB_PAD), dtype=bf,
                                                 device=dev)
    # one db partial a consumer warpgroup (2 a CTA, at most one CTA an SM)
    dbpart = torch.empty((2 * sms, B_NUMEL), dtype=f32, device=dev)
    dwpart = torch.empty((plan["chunks"], HIDDEN_NUMEL), dtype=f32,
                         device=dev)
    outpart = torch.empty((-(-n // OUT_CHUNK), W * OUT_PAD), dtype=f32,
                          device=dev)
    total = torch.empty((W_NUMEL + B_NUMEL,), dtype=f32, device=dev)
    lib, fwd = _lib_bwd(), _lib_fwd()
    stream = _build.stream_ptr(dev)
    _build.check(fwd.mlp_fwd_acts(
        x.data_ptr(), int(multires is not None), int(multires or 0),
        wflat.data_ptr(), bflat.data_ptr(), acts.data_ptr(),
        emb.data_ptr() if multires is not None else None, n, stream),
        "mlp_fwd_acts")
    ctas = ctypes.c_int(0)
    _build.check(fwd.mlp_delta(
        g.data_ptr(), wt.data_ptr(), acts.data_ptr(), deltas.data_ptr(),
        dbpart.data_ptr(), n, ctypes.byref(ctas), stream), "mlp_delta")
    blocks = (ctypes.c_int * (4 * len(_DW_BLOCKS)))(
        *[v for b in _DW_BLOCKS for v in b])
    _build.check(lib.mlp_bwd_dw(
        acts.data_ptr(), deltas.data_ptr(), emb.data_ptr(), dwpart.data_ptr(),
        blocks, n, plan["chunks"], plan["steps"], stream), "mlp_bwd_dw")
    _build.check(lib.mlp_bwd_dw_out(acts.data_ptr(), g.data_ptr(),
                                    outpart.data_ptr(), n, stream),
                 "mlp_bwd_dw_out")
    for part, lo, hi in ((dwpart, 0, HIDDEN_NUMEL),
                         (outpart, HIDDEN_NUMEL, W_NUMEL),
                         (dbpart[:2 * ctas.value], W_NUMEL,
                          W_NUMEL + B_NUMEL)):
        _build.check(lib.mlp_bwd_reduce(part.data_ptr(),
                                        total[lo:].data_ptr(), hi - lo,
                                        part.shape[0], stream),
                     "mlp_bwd_reduce")
    _build.count_launch("mlp_bwd", n)
    return split_flat(total[:W_NUMEL], total[W_NUMEL:])


# -- autograd entry points -------------------------------------------------------

class _FusedNeRF2D(torch.autograd.Function):
    """Packs the parameters once in the forward; on the card the flattened
    kernel buffers and K2's transposed stack stay in ctx for K2."""

    @staticmethod
    def forward(ctx, x, multires, emb_multires, cdt, *params):
        ctx.multires, ctx.emb_multires, ctx.cdt = multires, emb_multires, cdt
        ctx.save_for_backward(x, *params)
        ws, bs = pack_params(params, emb_multires)
        if x.is_cuda:
            ctx.flat = flatten_params(ws, bs, cdt)
            ctx.wt = transposed_stack(ctx.flat[0])
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
            dws, dbs = mlp_bwd_kernel(*ctx.flat, x, g, ctx.multires, ctx.wt)
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
