"""Texture sampling at per-pixel UVs; the port's counterpart of
contexture_nerf_tpu/ops/texture.py `sample_texture`: grid_sample semantics
with align_corners=False, zero padding and kaolin's v-flip, written as
explicit gathers in the reference's operation order.

The renderer samples a texture and multiplies by the views' mask
(`sample_texture_masked`). On the card that is K7 (csrc/texture.cu), a
kernel pair the JAX package has no counterpart of (it left the sampler to
XLA). Why it was added: autograd through the plain gathers scatters with
float atomics, and every background pixel (uv (0, 0)) sends its four taps
to one texel, so on the exact path's 6 x 1200^2 views some 77 M of the
104 M atomic adds serialised on 18 addresses, each adding exactly 0 (the
mask and the out-of-bounds taps zero them), ~60 ms a step. The UVs and the
mask of a paint are fixed, so the sampler is a fixed sparse operator S from
texels to pixels: the forward is image = S texture, one pass over the
pixels; the backward dtexture = S^T dimage is a gather over `TexturePlan`,
S^T as a texel-major list of the in-bounds taps of masked pixels, one
thread a texel summing its list in order. No atomics, so the sum order is
fixed and the gradient the same from run to run. Both kernels are bound by
the bytes they move (uv, mask, image and texture; the plan's entries, the
masked pixels' gradient and dtexture).

A CPU tensor takes the plain versions: `sample_texture` times the mask
forward (with no plan, exactly today's route), and the plan's segment sum
backward (`texture_bwd_plain`) when a plan is given. A CUDA tensor launches
K7 or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from contexture_nerf_tpu_torch.core.profiler import span
from contexture_nerf_tpu_torch.ops import _build

MODES = ("bilinear", "nearest")


def sample_texture(uv: torch.Tensor, texture: torch.Tensor,
                   mode: str = "bilinear") -> torch.Tensor:
    """Sample `texture` (B|1, C, TH, TW) at `uv` (B, H, W, 2) in [0, 1].
    Returns (B, H, W, C); differentiable w.r.t. the texture."""
    B = uv.shape[0]
    _, C, TH, TW = texture.shape
    u, v = uv[..., 0], uv[..., 1]
    px = u * TW - 0.5  # grid_sample pixel coordinate of grid = 2u - 1
    py = (1.0 - v) * TH - 0.5  # v flipped
    tex_flat = texture.reshape(texture.shape[0], C, TH * TW).expand(
        B, C, TH * TW)

    def gather(iy, ix):
        lin = (iy.clamp(0, TH - 1) * TW + ix.clamp(0, TW - 1)).reshape(B, 1, -1)
        out = torch.gather(tex_flat, 2, lin.expand(B, C, lin.shape[-1]))
        out = out.permute(0, 2, 1).reshape(*iy.shape, C)
        inb = ((iy >= 0) & (iy < TH) & (ix >= 0) & (ix < TW))[..., None]
        return torch.where(inb, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))

    if mode == "nearest":
        return gather(torch.floor(py + 0.5).long(),
                      torch.floor(px + 0.5).long())
    if mode != "bilinear":
        raise NotImplementedError(f"texture interpolation mode {mode}")
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = x0 + 1, y0 + 1
    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def masked_sample_plain(uv: torch.Tensor, mask: torch.Tensor,
                        texture: torch.Tensor,
                        mode: str = "bilinear") -> torch.Tensor:
    """`sample_texture` times the mask (B, 1, H, W), as (B, C, H, W): K7's
    forward, plainly."""
    image = sample_texture(uv, texture, mode) * mask.permute(0, 2, 3, 1)
    return image.permute(0, 3, 1, 2)


# -- the plan: S^T as a texel-major list --------------------------------------------

class TexturePlan(NamedTuple):
    """The sampler's transpose for fixed UVs (B, H, W, 2) and mask (B, 1, H,
    W): for each texel of the (texture_batch, TH, TW) texture, its entries
    offsets[t]:offsets[t + 1] of (pixel, weight), pixel b H W + y W + x of
    the (B, H, W) planes and weight the tap's bilinear weight (1 in
    `nearest`) times the pixel's mask. Only the in-bounds taps of pixels
    whose mask is not 0 are kept, sorted by (texel, view, pixel): the sum
    order of the backward. `kept`: the entries over B H W taps."""
    offsets: torch.Tensor  # (texture_batch TH TW + 1,) int32
    pixel: torch.Tensor  # (entries,) int32
    weight: torch.Tensor  # (entries,) f32
    views: Tuple[int, int, int]  # (B, H, W)
    size: Tuple[int, int]  # (TH, TW)
    texture_batch: int  # 1, or B: a texture per view
    mode: str
    kept: float


def _taps(uv: torch.Tensor, TH: int, TW: int, mode: str):
    """[(iy, ix, weight)] of each tap at uv (N, 2), in `sample_texture`'s
    arithmetic; the weights are the factors of the tap's value in the
    sample, y's first."""
    px = uv[:, 0] * TW - 0.5
    py = (1.0 - uv[:, 1]) * TH - 0.5
    if mode == "nearest":
        one = torch.ones_like(px)
        return [(torch.floor(py + 0.5).long(), torch.floor(px + 0.5).long(),
                 one)]
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    return [(y0, x0, (1 - wy) * (1 - wx)), (y0, x0 + 1, (1 - wy) * wx),
            (y0 + 1, x0, wy * (1 - wx)), (y0 + 1, x0 + 1, wy * wx)]


def texture_plan(uv: torch.Tensor, mask: torch.Tensor, size: Tuple[int, int],
                 mode: str = "bilinear",
                 texture_batch: int = 1) -> TexturePlan:
    """Build the `TexturePlan` of uv (B, H, W, 2) and mask (B, 1, H, W) for a
    (texture_batch, C, TH, TW) texture, on their device: one sort of the
    kept taps; its host reads are the counts of kept pixels and taps."""
    if mode not in MODES:
        raise NotImplementedError(f"texture interpolation mode {mode}")
    B, H, W = uv.shape[:3]
    TH, TW = size
    if tuple(mask.shape) != (B, 1, H, W):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, 1, H, W) of "
                         f"uv {tuple(uv.shape)}")
    if texture_batch not in (1, B):
        raise ValueError(f"a texture batch of {texture_batch} for {B} views")
    P, T = B * H * W, texture_batch * TH * TW
    if P >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("K7's plan indexes pixels and texels in int32")
    m = mask.reshape(P)
    pix = torch.nonzero(m != 0)[:, 0]
    uvk = uv.reshape(P, 2)[pix].float()
    mk = m[pix].float()
    tb = pix // (H * W) if texture_batch > 1 else torch.zeros_like(pix)
    texels, pixels, weights = [], [], []
    taps = _taps(uvk, TH, TW, mode)
    for iy, ix, w in taps:
        inb = (iy >= 0) & (iy < TH) & (ix >= 0) & (ix < TW)
        texels.append(((tb * TH + iy) * TW + ix)[inb])
        pixels.append(pix[inb])
        weights.append((mk * w)[inb])
    texel, pixel = torch.cat(texels), torch.cat(pixels)
    key, order = torch.sort(texel * P + pixel)
    counts = torch.bincount(key // P, minlength=T)
    offsets = torch.zeros(T + 1, dtype=torch.int32, device=uv.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return TexturePlan(
        offsets=offsets, pixel=(key % P).to(torch.int32),
        weight=torch.cat(weights)[order].contiguous(), views=(B, H, W),
        size=(TH, TW), texture_batch=texture_batch, mode=mode,
        kept=key.numel() / max(P * len(taps), 1))


def _dense_stride(t: torch.Tensor) -> Tuple[int, ...]:
    """t's strides where its elements tile its storage without gaps or
    overlaps (a permuted contiguous tensor), else the contiguous strides:
    the layout of t's gradient."""
    step = 1
    for s, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n > 1):
        if s != step:
            return torch.empty(t.shape, device="meta").stride()
        step *= n
    return t.stride()


def texture_bwd_plain(plan: TexturePlan, g: torch.Tensor,
                      texture: torch.Tensor) -> torch.Tensor:
    """dtexture = S^T g for g (B, C, H, W), the gradient of the masked
    sample: each texel's entries' g times weight, summed in the plan's order
    (a segment sum from 0; on the CPU one texel after another), on g's
    device in the shape, dtype and layout (`_dense_stride`) of `texture`
    (the texture, or a meta tensor like it). K7's backward, plainly."""
    B, H, W = plan.views
    C = g.shape[1]
    gp = g.permute(0, 2, 3, 1).reshape(B * H * W, C)[plan.pixel.long()]
    rows = torch.segment_reduce(gp * plan.weight[:, None], "sum",
                                offsets=plan.offsets.long(), axis=0)
    out = torch.empty_strided(texture.shape, _dense_stride(texture),
                              dtype=texture.dtype, device=g.device)
    out.copy_(rows.reshape(plan.texture_batch, *plan.size, C)
              .permute(0, 3, 1, 2))
    return out


# -- the kernels ----------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("texture")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.texture_fwd.argtypes = [p, p, p, q, q, q, q, i, i, i, i, i, i, i,
                                    p, p]
        lib.texture_bwd.argtypes = [p, p, p, p, q, q, q, q, i, i, i, p, q, q,
                                    q, q, i, i, p]
        lib.texture_fwd.restype = lib.texture_bwd.restype = i
        _LIB = lib
    return _LIB


def _check(uv, mask, texture, mode):
    """Raise on what K7 does not take; returns (B, H, W, TH, TW)."""
    for name, t in (("uv", uv), ("mask", mask), ("texture", texture)):
        if not t.is_cuda or t.device != texture.device:
            raise ValueError(f"K7 takes CUDA tensors on one device; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"K7 takes float32; {name} is {t.dtype}")
    if mode not in MODES:
        raise NotImplementedError(f"texture interpolation mode {mode}")
    if uv.dim() != 4 or uv.shape[-1] != 2 or not uv.is_contiguous() \
            or uv.data_ptr() % 8:
        raise ValueError(f"uv must be a contiguous (B, H, W, 2) tensor "
                         f"aligned to 8 bytes; got {tuple(uv.shape)}")
    B, H, W = uv.shape[:3]
    if tuple(mask.shape) != (B, 1, H, W) or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous (B, 1, H, W) = "
                         f"{(B, 1, H, W)}; got {tuple(mask.shape)}")
    if texture.dim() != 4 or texture.shape[1] != 3 \
            or texture.shape[0] not in (1, B):
        raise ValueError(f"texture must be (1 or {B}, 3, TH, TW); got "
                         f"{tuple(texture.shape)}")
    TH, TW = texture.shape[2:]
    if B * H * W >= 2 ** 31 or texture.shape[0] * TH * TW >= 2 ** 31:
        raise ValueError("K7 indexes pixels and texels in int32")
    return B, H, W, TH, TW


def texture_fwd_kernel(uv: torch.Tensor, mask: torch.Tensor,
                       texture: torch.Tensor,
                       mode: str = "bilinear") -> torch.Tensor:
    """K7's forward on the card: `masked_sample_plain`'s (B, 3, H, W), bit
    for bit, written contiguous; the texture is read in any layout. A pixel
    whose mask is 0 reads nothing and writes 0. Under the profiler the call,
    checks to launch, is the span `k7.fwd`."""
    with span("k7.fwd"):
        B, H, W, TH, TW = _check(uv, mask, texture, mode)
        out = torch.empty((B, 3, H, W), dtype=torch.float32,
                          device=texture.device)
        err = _lib().texture_fwd(
            uv.data_ptr(), mask.data_ptr(), texture.data_ptr(),
            *texture.stride(), int(texture.shape[0] > 1), B, H, W, TH, TW,
            int(mode == "nearest"), out.data_ptr(),
            _build.stream_ptr(texture.device))
        _build.check(err, "texture_fwd")
        _build.count_launch("texture_fwd", B, H, W, TH, TW)
        return out


def texture_bwd_kernel(plan: TexturePlan, g: torch.Tensor,
                       texture: torch.Tensor) -> torch.Tensor:
    """K7's backward on the card: `texture_bwd_plain` bit for bit (one
    thread a texel sums its entries in the plan's order from 0), g (B, 3,
    H, W) float32 in any layout, dtexture written once for every texel, on
    g's device in the layout of `texture` (the texture, or a meta tensor
    like it; `_dense_stride`). Under the profiler the call, checks to
    launch, is the span `k7.bwd`."""
    with span("k7.bwd"):
        B, H, W = plan.views
        TH, TW = plan.size
        Bt = plan.texture_batch
        for name, t in (("g", g), ("offsets", plan.offsets),
                        ("pixel", plan.pixel), ("weight", plan.weight)):
            if not t.is_cuda or t.device != g.device:
                raise ValueError(f"K7 takes CUDA tensors on one device; "
                                 f"{name} is on {t.device}")
        if g.dtype != torch.float32 or texture.dtype != torch.float32:
            raise ValueError(f"K7 takes float32; g is {g.dtype}, the "
                             f"texture {texture.dtype}")
        if tuple(g.shape) != (B, 3, H, W) or \
                tuple(texture.shape) != (Bt, 3, TH, TW):
            raise ValueError(f"g {tuple(g.shape)} and the texture "
                             f"{tuple(texture.shape)} are not the plan's "
                             f"{(B, 3, H, W)} and {(Bt, 3, TH, TW)}")
        if plan.offsets.dtype != torch.int32 or \
                plan.pixel.dtype != torch.int32 or \
                plan.weight.dtype != torch.float32 or \
                plan.offsets.numel() != Bt * TH * TW + 1 or \
                not all(t.is_contiguous() for t in plan[:3]):
            raise ValueError("the plan's offsets and pixels must be "
                             "contiguous int32, its weights float32")
        out = torch.empty_strided(texture.shape, _dense_stride(texture),
                                  dtype=torch.float32, device=g.device)
        err = _lib().texture_bwd(
            plan.offsets.data_ptr(), plan.pixel.data_ptr(),
            plan.weight.data_ptr(), g.data_ptr(), *g.stride(), H * W, W,
            Bt * TH * TW, out.data_ptr(), *out.stride(), TH, TW,
            _build.stream_ptr(g.device))
        _build.check(err, "texture_bwd")
        _build.count_launch("texture_bwd", B, H, W, TH, TW)
        return out


class _MaskedSample(torch.autograd.Function):
    """The masked sample, differentiable w.r.t. the texture: K7 on the card,
    the plain versions on the CPU; the backward over `plan`, built from the
    saved uv and mask when none was given."""

    @staticmethod
    def forward(ctx, texture, uv, mask, mode, plan):
        ctx.save_for_backward(uv, mask)
        ctx.mode, ctx.plan = mode, plan
        ctx.texture = torch.empty_strided(texture.shape, texture.stride(),
                                          dtype=texture.dtype, device="meta")
        if texture.is_cuda:
            return texture_fwd_kernel(uv, mask, texture, mode)
        return masked_sample_plain(uv, mask, texture, mode)

    @staticmethod
    def backward(ctx, g):
        uv, mask = ctx.saved_tensors
        like, plan = ctx.texture, ctx.plan
        if plan is None:
            plan = texture_plan(uv, mask, tuple(like.shape[2:]), ctx.mode,
                                like.shape[0])
        bwd = texture_bwd_kernel if g.is_cuda else texture_bwd_plain
        return bwd(plan, g, like), None, None, None, None


def sample_texture_masked(uv: torch.Tensor, mask: torch.Tensor,
                          texture: torch.Tensor, mode: str = "bilinear",
                          plan: Optional[TexturePlan] = None) -> torch.Tensor:
    """The texture (B|1, 3, TH, TW) sampled at uv (B, H, W, 2) times mask (B,
    1, H, W): (B, 3, H, W). A CUDA texture takes K7: the autograd Function
    where a gradient is wanted (its backward over `plan`, or a plan built
    for the call), the forward kernel alone otherwise. A CPU texture takes
    `masked_sample_plain`, or with a plan the Function over the plain
    versions. `plan` must be `texture_plan` of this uv and mask."""
    if plan is not None and (plan.views != tuple(uv.shape[:3])
                             or plan.size != tuple(texture.shape[2:])
                             or plan.texture_batch != texture.shape[0]
                             or plan.mode != mode):
        raise ValueError(f"a plan of views {plan.views}, texture "
                         f"{plan.texture_batch} x {plan.size}, {plan.mode}, "
                         f"for views {tuple(uv.shape[:3])}, texture "
                         f"{tuple(texture.shape)}, {mode}")
    grad = torch.is_grad_enabled() and texture.requires_grad
    if texture.is_cuda:
        if grad:
            return _MaskedSample.apply(texture, uv, mask, mode, plan)
        return texture_fwd_kernel(uv, mask, texture, mode)
    if texture.device.type != "cpu":
        raise ValueError(f"unsupported device {texture.device}")
    if grad and plan is not None:
        return _MaskedSample.apply(texture, uv, mask, mode, plan)
    return masked_sample_plain(uv, mask, texture, mode)
