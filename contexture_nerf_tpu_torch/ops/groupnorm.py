"""GroupNorm(+SiLU): the CUDA kernel (K6, csrc/groupnorm.cu), its plain
version, and the dispatch.

Counterpart of contexture_nerf_tpu/ops/groupnorm.py: `group_norm_silu_plain`
is `group_norm_silu_reference`, the kernel replaces the Pallas `_kernel`
(reached by `group_norm_silu_pallas`), `group_norm_silu` is `_dispatch`
under the custom VJP, whose backward recomputes through the plain version.
Tensors here are NCHW; statistics are f32 over (C/groups, H, W) per group,
biased variance E[x^2] - mean^2, then the affine, the optional SiLU and the
cast.

The reference keeps its kernel off (`USE_PALLAS = False`): on a TPU, XLA
fuses the chain to the same two reads and one write. Eager PyTorch fuses
nothing (the plain version is some ten launches and several f32 copies of
x), so the port's switch `USE_KERNEL` is on: a CUDA tensor goes to K6, and
to the plain version only when the switch is off (chip_smoke.py turns it off
to time the plain path). A CPU tensor takes the plain version. A CUDA tensor
that the kernel does not take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from contexture_nerf_tpu_torch.ops import _build

USE_KERNEL = True

THREADS = 512  # the kernel's CTA size
LAUNCHES_PER_CALL = 1  # every plan is one launch (gn_fused)
SMS = 132  # the H100's SMs: the plan gives every SM at least one CTA
SMEM_CAP = 112 * 1024  # bytes of x a CTA keeps on chip: two CTAs an SM
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
    pack = 16 // itemsize
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
    keep = min(chunk, SMEM_CAP // itemsize) if vec else 0
    path = ("cta" if cs == 1 else "cluster") + (
        "+overflow" if keep < chunk else "")
    return Plan(path, cs, chunk, keep, vec)


_LIB = None
_MAX_CLUSTER = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("groupnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_fwd.argtypes = [p, p, p, p] + [i] * 12 + [
            ctypes.c_float, i, i, p]
        lib.groupnorm_fwd.restype = i
        lib.groupnorm_max_cluster.argtypes = []
        lib.groupnorm_max_cluster.restype = i
        _LIB = lib
    return _LIB


def max_cluster() -> int:
    """The largest cluster (16, 8 or 4) of which the card can hold one at
    full shared memory; asked once."""
    global _MAX_CLUSTER
    if _MAX_CLUSTER is None:
        cs = _lib().groupnorm_max_cluster()
        if cs <= 0:
            raise RuntimeError("K6: the card cannot hold a cluster of 4 CTAs "
                               "at full shared memory")
        _MAX_CLUSTER = cs
    return _MAX_CLUSTER


def kernel_plan(x: torch.Tensor, groups: int = 32) -> Plan:
    """The plan K6 takes for this x on the card."""
    bg = x.shape[0] * groups
    return plan(x.numel() // bg, bg, x.element_size(),
                x.data_ptr() % 16 == 0, max_cluster())


def group_norm_silu_kernel(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int = 32,
                           eps: float = 1e-5, act: bool = True,
                           out_dtype=None) -> torch.Tensor:
    """K6 on the card: x (B, C, ...) contiguous, bf16 or f32; out_dtype bf16
    or f32; scale and bias (C,) contiguous, bf16 or f32, read as they are."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu_kernel takes a CUDA tensor, got "
                         f"{x.device}")
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
    bg = B * groups
    n = x.numel() // bg
    if n >= 2 ** 31:
        raise ValueError(f"K6: groups of {n} elements are beyond its int32 "
                         "offsets")
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
    _build.count_launch("groupnorm", *x.shape, n=LAUNCHES_PER_CALL)
    return out


class _GroupNormSiLUKernel(torch.autograd.Function):
    """K6 forward; the backward recomputes through the plain version, as
    the reference's custom VJP does (it has no backward kernel)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act, out_dtype):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, act, out_dtype)
        return group_norm_silu_kernel(x, scale, bias, groups, eps, act,
                                      out_dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
            y = group_norm_silu_plain(*ins, *ctx.args)
            got = iter(torch.autograd.grad(
                y, [t for t, r in zip(ins, need) if r], g))
        grads = [next(got) if r else None for r in need]
        return (*grads, None, None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, act: bool = True,
                    out_dtype=None) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW x, differentiable: K6 for a CUDA tensor
    (through the autograd Function only where a gradient is wanted; the
    plain version when USE_KERNEL is off), the plain version for a CPU
    tensor."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        if USE_KERNEL:
            if torch.is_grad_enabled() and (
                    x.requires_grad or scale.requires_grad
                    or bias.requires_grad):
                return _GroupNormSiLUKernel.apply(x, scale, bias, groups, eps,
                                                  act, out_dtype)
            return group_norm_silu_kernel(x, scale, bias, groups, eps, act,
                                          out_dtype)
    elif x.device.type != "cpu":
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

