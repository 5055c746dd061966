"""GroupNorm(+SiLU): the CUDA kernel (K6, csrc/groupnorm.cu), its plain
version, and the dispatch.

Counterpart of contexture_nerf_tpu/ops/groupnorm.py: `group_norm_silu_plain`
is `group_norm_silu_reference`, the kernel replaces the Pallas `_kernel`
(reached by `group_norm_silu_pallas`), `group_norm_silu` is `_dispatch`
under the custom VJP, whose backward recomputes through the plain version;
the port's backward is a kernel too (`gn_bwd` in the same source), with
`group_norm_silu_bwd_plain`, the gradient in closed form, as its plain
version. Tensors here are NCHW; statistics are f32 over (C/groups, H, W) per
group, biased variance E[x^2] - mean^2, then the affine, the optional SiLU
and the cast.

The reference keeps its kernel off (`USE_PALLAS = False`): on a TPU, XLA
fuses the chain to the same two reads and one write. Eager PyTorch fuses
nothing (the plain version is some ten launches and several f32 copies of
x), so the port has no such switch: a CUDA tensor goes to K6 (and its
gradient to gn_bwd), a CPU tensor to the plain version. A CUDA tensor that
the kernel does not take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from contexture_nerf_tpu_torch.core.profiler import span
from contexture_nerf_tpu_torch.ops import _build

THREADS = 512  # the kernel's CTA size
SMS = 132  # the H100's SMs: the plan gives every SM at least one CTA
SMEM_CAP = 112 * 1024  # bytes a CTA keeps on chip (x; gn_bwd x and g): two an SM
PIECE_BYTES = THREADS * 4 * 16  # one bulk copy (csrc PIECE_VECS vectors)
MIN_CTA_BYTES = 16 * 1024  # a CTA's share is not split below this
MAX_CLUSTER = 16  # the largest (non-portable) cluster on an H100
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int = 32,
                          eps: float = 1e-5, act: bool = True,
                          out_dtype=None) -> torch.Tensor:
    """x (B, C, ...) -> GroupNorm(x) * scale + bias, SiLU if act, cast to
    out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    B, C = x.shape[0], x.shape[1]
    xf = x.float().reshape(B, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if act:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype)


def group_norm_silu_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, g: torch.Tensor,
                              groups: int = 32, eps: float = 1e-5,
                              act: bool = True, need=(True, True, True)):
    """The gradients (dx, dscale, dbias) of group_norm_silu_plain(x, scale,
    bias, groups, eps, act) for the gradient g of its output, in closed
    form (gn_bwd's specification); None where `need` does not ask. In f32
    (f64 for f64 inputs) per group: xhat = (x - mean) rstd, y = xhat scale +
    bias; g' = g s (1 + y (1 - s)) with s = sigmoid(y) when act, else g;
    dxhat = g' scale; dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat
    xhat)) in x's dtype; dscale = sum of g' xhat and dbias = sum of g' over
    the batch and the positions, in scale's and bias's dtypes."""
    B, C = x.shape[0], x.shape[1]
    shape = (1, C) + (1,) * (x.dim() - 2)
    ct = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(ct).reshape(B, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(x.shape)
    s = scale.to(ct).reshape(shape)
    gp = g.to(ct)
    if act:
        y = xhat * s + bias.to(ct).reshape(shape)
        sig = torch.sigmoid(y)
        gp = gp * sig * (1 + y * (1 - sig))
    dims = [0] + list(range(2, x.dim()))
    dx = dscale = dbias = None
    if need[0]:
        dxhat = (gp * s).reshape(B, groups, -1)
        xh = xhat.reshape(B, groups, -1)
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xh).mean(dim=-1, keepdim=True)
        dx = (rstd * (dxhat - m1 - xh * m2)).reshape(x.shape).to(x.dtype)
    if need[1]:
        dscale = (gp * xhat).sum(dims).to(scale.dtype)
    if need[2]:
        dbias = gp.sum(dims).to(bias.dtype)
    return dx, dscale, dbias


class Plan(NamedTuple):
    """How K6 covers one group of n elements: `cluster` CTAs (ranks) of
    `chunk` elements each, the first `keep` of each rank's share kept in
    shared memory, the rest (the overflow) read again from device memory;
    `vec`: 16-byte vectors (else element by element, nothing kept)."""
    path: str
    cluster: int
    chunk: int
    keep: int
    vec: bool


@functools.lru_cache(maxsize=1024)
def plan(n: int, bg: int, itemsize: int, vec: bool = True,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """K6's plan for bg groups of n elements of `itemsize` bytes. The
    cluster doubles while a rank's share exceeds SMEM_CAP, or while the
    grid leaves SMs without a CTA and halving the share keeps it at least
    MIN_CTA_BYTES; up to max_cluster. Ranks get equal chunks (multiples of
    the 16-byte pack with vec; vec also needs n to be a multiple of it), and
    the cluster is cut to the ranks that hold elements. Path: "cta" or
    "cluster", "+overflow" where a share exceeds what is kept."""
    return _plan(n, bg, itemsize, 16 // itemsize, vec, max_cluster)


@functools.lru_cache(maxsize=1024)
def bwd_plan(n: int, bg: int, itemsize: int, g_itemsize: int,
             vec: bool = True, max_cluster: int = MAX_CLUSTER) -> Plan:
    """gn_bwd's plan for bg groups of n elements, x of `itemsize` bytes and
    g of `g_itemsize`: `plan`'s rule over both together, so a rank keeps
    `keep` elements of x and as many of g within SMEM_CAP; the pack is 16
    bytes of the narrower of the two."""
    return _plan(n, bg, itemsize + g_itemsize,
                 16 // min(itemsize, g_itemsize), vec, max_cluster)


def _plan(n, bg, itemsize, pack, vec, max_cluster) -> Plan:
    vec = vec and n % pack == 0
    unit = pack if vec else 1
    nbytes = n * itemsize
    cs = 1
    while cs < max_cluster and (
            nbytes > cs * SMEM_CAP
            or (bg * cs < SMS and nbytes >= 2 * cs * MIN_CTA_BYTES)):
        cs = min(2 * cs, max_cluster)
    chunk = -(-n // cs)
    chunk += (-chunk) % unit
    cs = -(-n // chunk)
    keep = min(chunk, SMEM_CAP // itemsize // unit * unit) if vec else 0
    path = ("cta" if cs == 1 else "cluster") + (
        "+overflow" if keep < chunk else "")
    return Plan(path, cs, chunk, keep, vec)


_LIB = None
_MAX_CLUSTER = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("groupnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_fwd.argtypes = [p, p, p, p] + [i] * 12 + [
            ctypes.c_float, i, i, p]
        lib.groupnorm_fwd.restype = i
        lib.groupnorm_bwd.argtypes = [p] * 6 + [i] * 12 + [
            ctypes.c_float, i, i, p]
        lib.groupnorm_bwd.restype = i
        for fn in (lib.groupnorm_max_cluster, lib.groupnorm_bwd_max_cluster):
            fn.argtypes = []
            fn.restype = i
        _LIB = lib
    return _LIB


def max_cluster(bwd: bool = False) -> int:
    """The largest cluster (16, 8 or 4) of the forward kernel (or of
    gn_bwd) of which the card can hold one at full shared memory; asked
    once."""
    if bwd not in _MAX_CLUSTER:
        lib = _lib()
        cs = (lib.groupnorm_bwd_max_cluster if bwd
              else lib.groupnorm_max_cluster)()
        if cs <= 0:
            raise RuntimeError("K6: the card cannot hold a cluster of 4 CTAs "
                               "at full shared memory")
        _MAX_CLUSTER[bwd] = cs
    return _MAX_CLUSTER[bwd]


def kernel_plan(x: torch.Tensor, groups: int = 32) -> Plan:
    """The plan K6 takes for this x on the card."""
    bg = x.shape[0] * groups
    return plan(x.numel() // bg, bg, x.element_size(),
                x.data_ptr() % 16 == 0, max_cluster())


def bwd_kernel_plan(x: torch.Tensor, g: torch.Tensor,
                    groups: int = 32) -> Plan:
    """The plan gn_bwd takes for this x and output gradient g on the card
    (its dx is a new, aligned allocation)."""
    bg = x.shape[0] * groups
    return bwd_plan(x.numel() // bg, bg, x.element_size(), g.element_size(),
                    x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0,
                    max_cluster(bwd=True))


def group_norm_silu_kernel(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int = 32,
                           eps: float = 1e-5, act: bool = True,
                           out_dtype=None) -> torch.Tensor:
    """K6 on the card: x (B, C, ...) contiguous, bf16 or f32; out_dtype bf16
    or f32; scale and bias (C,) contiguous, bf16 or f32, read as they are.
    Under the profiler the call, checks to launch, is the span `k6.fwd`."""
    with span("k6.fwd"):
        return _group_norm_silu_kernel(x, scale, bias, groups, eps, act,
                                       out_dtype)


def _check(x, scale, bias, groups, out_dtype, what):
    """Raise on what K6 (or gn_bwd, with out_dtype the gradient's) does not
    take; returns (B, C, n)."""
    if not x.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor, got {x.device}")
    if x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"K6 takes bfloat16 or float32 in and out; got "
                         f"{x.dtype} -> {out_dtype}")
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError(f"x {tuple(x.shape)}: expected (B, C, ...) with C "
                         f"a multiple of groups={groups}")
    if not x.is_contiguous():
        raise ValueError("K6 takes a contiguous (NCHW) x")
    B, C = x.shape[:2]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (C,) or t.device != x.device \
                or t.dtype not in KERNEL_DTYPES or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({C},) bfloat16 or "
                             f"float32 on {x.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    n = x.numel() // (B * groups)
    if n >= 2 ** 31:
        raise ValueError(f"K6: groups of {n} elements are beyond its int32 "
                         "offsets")
    return B, C, n


def _group_norm_silu_kernel(x, scale, bias, groups, eps, act, out_dtype):
    out_dtype = out_dtype or x.dtype
    B, C, n = _check(x, scale, bias, groups, out_dtype,
                     "group_norm_silu_kernel")
    bg = B * groups
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    p = kernel_plan(x, groups)
    bf = torch.bfloat16
    err = _lib().groupnorm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.dtype == bf, out_dtype == bf, scale.dtype == bf, bias.dtype == bf,
        bg, groups, C // groups, n, n // (C // groups), p.cluster, p.chunk,
        p.keep, eps, act, p.vec, _build.stream_ptr(x.device))
    _build.check(err, "groupnorm_fwd")
    _build.count_launch("groupnorm", *x.shape)
    return out


def group_norm_silu_bwd_kernel(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, g: torch.Tensor,
                               groups: int = 32, eps: float = 1e-5,
                               act: bool = True, need=(True, True, True)):
    """gn_bwd on the card: `group_norm_silu_bwd_plain`'s (dx, dscale,
    dbias) for x and scale, bias as K6 takes them and g, the output's
    gradient, bf16 or f32 and shaped like x (a strided g is copied
    contiguous first). One launch; dscale and dbias add the kernel's
    per-rank sums in order. Under the profiler the call, the copy and the
    checks to the last result, is the span `k6.bwd`."""
    with span("k6.bwd"):
        return _group_norm_silu_bwd_kernel(x, scale, bias, g.contiguous(),
                                           groups, eps, act, need)


def _group_norm_silu_bwd_kernel(x, scale, bias, g, groups, eps, act, need):
    B, C, n = _check(x, scale, bias, groups, g.dtype,
                     "group_norm_silu_bwd_kernel")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} must be shaped "
                         f"like x {tuple(x.shape)} on {x.device}")
    bg = B * groups
    dx = torch.empty_like(x) if need[0] else None
    if x.numel() == 0:
        return dx, *(torch.zeros_like(t) if r else None
                     for t, r in zip((scale, bias), need[1:]))
    p = bwd_kernel_plan(x, g, groups)
    cpg = C // groups
    part = torch.empty((bg * p.cluster, cpg, 2), dtype=torch.float32,
                       device=x.device) if need[1] or need[2] else None
    bf = torch.bfloat16
    err = _lib().groupnorm_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        dx.data_ptr() if dx is not None else None,
        part.data_ptr() if part is not None else None,
        x.dtype == bf, g.dtype == bf, scale.dtype == bf, bias.dtype == bf,
        bg, groups, cpg, n, n // cpg, p.cluster, p.chunk, p.keep, eps, act,
        p.vec, _build.stream_ptr(x.device))
    _build.check(err, "groupnorm_bwd")
    _build.count_launch("groupnorm_bwd", *x.shape)
    if part is None:
        return dx, None, None
    sums = part.view(B, groups, p.cluster, cpg, 2).sum((0, 2)).view(C, 2)
    return dx, *(sums[:, i].to(t.dtype).contiguous() if r else None
                 for i, (t, r) in enumerate(zip((scale, bias), need[1:])))


class _GroupNormSiLUKernel(torch.autograd.Function):
    """K6 forward, gn_bwd backward (its statistics recomputed from x, so
    the forward saves its inputs only)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act, out_dtype):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, act)
        return group_norm_silu_kernel(x, scale, bias, groups, eps, act,
                                      out_dtype)

    @staticmethod
    def backward(ctx, g):
        grads = group_norm_silu_bwd_kernel(
            *ctx.saved_tensors, g, *ctx.args,
            need=ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, act: bool = True,
                    out_dtype=None) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW x, differentiable: K6 for a CUDA tensor
    (through the autograd Function only where a gradient is wanted), the
    plain version for a CPU tensor."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        if torch.is_grad_enabled() and (
                x.requires_grad or scale.requires_grad or bias.requires_grad):
            return _GroupNormSiLUKernel.apply(x, scale, bias, groups, eps,
                                              act, out_dtype)
        return group_norm_silu_kernel(x, scale, bias, groups, eps, act,
                                      out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return group_norm_silu_plain(x, scale, bias, groups, eps, act, out_dtype)


class GroupNormSiLU(torch.nn.Module):
    """GroupNorm -> SiLU -> cast as one op; act=False is plain GroupNorm +
    cast. Parameters `weight`/`bias` (flax `scale`/`bias`)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 act: bool = True, out_dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.act, self.out_dtype = \
            groups, eps, act, out_dtype
        self.weight = torch.nn.Parameter(torch.ones(channels))
        self.bias = torch.nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.groups,
                               self.eps, self.act, self.out_dtype)

