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

import torch

from contexture_nerf_tpu_torch.ops import _build

USE_KERNEL = True

THREADS = 256  # the kernel's CTA size
LAUNCHES_PER_CALL = 2  # gn_stats, then gn_apply
TARGET_CTAS = 8 * 132  # CTAs to put in flight: 8 for each of the H100's SMs
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


def kernel_split(n: int, bg: int, itemsize: int):
    """How K6 cuts each group of n elements (bg groups in all, x of
    `itemsize` bytes): (S chunks a group, chunk length, vec). Enough chunks
    to put about TARGET_CTAS CTAs in flight, none shorter than one 16-byte
    load a thread; with vec (n a multiple of the 16-byte pack) the chunk is
    a multiple of the pack, so every load is aligned."""
    pack = 16 // itemsize
    vec = n % pack == 0
    s = max(1, min(-(-TARGET_CTAS // bg), -(-n // (THREADS * pack))))
    chunk = -(-n // s)
    if vec:
        chunk += (-chunk) % pack
    return -(-n // chunk), chunk, vec


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("groupnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      i, ctypes.c_float, i, i, p]
        lib.groupnorm_fwd.restype = i
        _LIB = lib
    return _LIB


def group_norm_silu_kernel(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int = 32,
                           eps: float = 1e-5, act: bool = True,
                           out_dtype=None) -> torch.Tensor:
    """K6 on the card: x (B, C, ...) contiguous, bf16 or f32; out_dtype bf16
    or f32; scale and bias (C,), taken as f32."""
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
        if t.shape != (C,) or t.device != x.device:
            raise ValueError(f"{name} must be ({C},) on {x.device}; got "
                             f"{tuple(t.shape)} on {t.device}")
    bg = B * groups
    n = x.numel() // bg
    hw = n // (C // groups)
    if n >= 2 ** 31 or bg > 65535:
        raise ValueError(f"K6: {bg} groups of {n} elements is beyond its "
                         "int32 offsets or its grid")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    s, chunk, vec = kernel_split(n, bg, x.element_size())
    vec = vec and x.data_ptr() % 16 == 0
    partial = torch.empty((bg * s, 2), dtype=torch.float32, device=x.device)
    sc = scale.to(torch.float32).contiguous()
    bi = bias.to(torch.float32).contiguous()
    err = _lib().groupnorm_fwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), partial.data_ptr(),
        out.data_ptr(), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), bg, groups, C // groups, n, hw, s,
        chunk, float(eps), int(act), int(vec), _build.stream_ptr(x.device))
    _build.check(err, "groupnorm_fwd")
    _build.launch_counts["groupnorm"] += LAUNCHES_PER_CALL
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
    (the plain version when USE_KERNEL is off), the plain version for a CPU
    tensor."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        if USE_KERNEL:
            return _GroupNormSiLUKernel.apply(x, scale, bias, groups, eps,
                                              act, out_dtype)
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

