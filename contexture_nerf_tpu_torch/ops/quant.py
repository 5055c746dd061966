"""Dynamic symmetric int8 quantization (W8A8) of the teacher's convs and
Dense layers; counterpart of contexture_nerf_tpu/ops/quant.py.

Scheme, as the reference: round-to-nearest (half to even) int8 in
[-127, 127] with f32 scales amax / 127 (amax floored at 1e-8), int32
accumulation, then `(acc.float() * s_act * s_w).to(x.dtype)`.
  - linear: per-row activation scales over the contracting (last) axis,
    per-output-column weight scales;
  - conv2d: ONE activation scale over the whole tensor, the batch included
    (a 3x3 window mixes pixels, so no per-pixel scale factors out of the
    sum), per-output-channel weight scales.
The batch a conv sees therefore changes its result: callers run each
quantized tower on exactly the batch the reference runs it on.

The reference has no Pallas kernel here: its products are XLA's
`dot_general` / `conv_general_dilated` with int32 accumulation. The port
computes them as `torch._int_mm`, the conv as int8 patches (F.pad and
Tensor.unfold, which take any dtype) times `_int_mm`. Integer sums are
exact, so q, the scales and the int32 sums equal the reference's bit for
bit. On the card `_int_mm` wants more than 16 rows and K, N multiples of 8:
rows are zero-padded (exact), and any other shape raises. There is no
float fallback.

The backward of both ops is the exact (unquantized) op's, as the
reference's custom VJPs: quantization is forward-only.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

MIN_ROWS_CUDA = 17  # _int_mm on CUDA: more than 16 rows
ALIGN_CUDA = 8  # _int_mm on CUDA: K and N multiples of 8


_QMAX: Dict[torch.device, torch.Tensor] = {}


def _qmax(device: torch.device) -> torch.Tensor:
    """127.0 as a 0-dim f32 tensor on `device`, made once. CUDA divides by
    a Python (host) scalar as a product with its reciprocal, which can be
    one ulp off the quotient the reference takes; by a device tensor it
    divides."""
    if device not in _QMAX:
        _QMAX[device] = torch.tensor(127.0, device=device)
    return _QMAX[device]


def quantize_int8(x: torch.Tensor, dims: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice over `dims` (keepdim):
    (q int8, scale f32), x ~= q * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(dims), keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / _qmax(amax.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through torch._int_mm.
    On the card, M <= 16 is zero-padded to 17 rows; K or N not a multiple
    of 8 raises."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda:
        if K % ALIGN_CUDA or N % ALIGN_CUDA:
            raise ValueError(
                f"int8 product ({M}, {K}) x ({K}, {N}): torch._int_mm on "
                f"CUDA needs K and N multiples of {ALIGN_CUDA}")
        if M < MIN_ROWS_CUDA:
            pad = a.new_zeros((MIN_ROWS_CUDA - M, K))
            return torch._int_mm(torch.cat([a, pad]), b)[:M]
    return torch._int_mm(a.contiguous(), b)


def linear_int32(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) times the int8 torch-layout weight (N, K) -> int32
    (..., N)."""
    K = q_x.shape[-1]
    acc = int_mm(q_x.reshape(-1, K), q_w.t())
    return acc.reshape(*q_x.shape[:-1], q_w.shape[0])


def conv_patches(q_x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """int8 NCHW -> its (B Ho Wo, C kh kw) patch matrix, rows (b, y, x),
    columns (c, i, j) as the (O, I, kh, kw) weight flattens; and
    (B, Ho, Wo)."""
    B, C = q_x.shape[:2]
    xp = F.pad(q_x, (padding,) * 4) if padding else q_x
    patches = xp.unfold(2, kh, stride).unfold(3, kw, stride)
    Ho, Wo = patches.shape[2], patches.shape[3]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo,
                                                     C * kh * kw)
    return cols, (B, Ho, Wo)


def conv2d_int32(q_x: torch.Tensor, q_w: torch.Tensor, stride: int,
                 padding: int) -> torch.Tensor:
    """int8 NCHW input and int8 (O, I, kh, kw) weight -> the int32 NCHW
    cross-correlation: the patches times _int_mm."""
    O, _, kh, kw = q_w.shape
    cols, (B, Ho, Wo) = conv_patches(q_x, kh, kw, stride, padding)
    acc = int_mm(cols, q_w.reshape(O, -1).t())
    return acc.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        q_x, s_x = quantize_int8(x, (-1,))  # (..., 1)
        q_w, s_w = quantize_int8(weight, (1,))  # (N, 1)
        acc = linear_int32(q_x, q_w)
        return (acc.float() * s_x * s_w.reshape(-1)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ weight
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return gx, gw


class _Int8Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        q_x, s_x = quantize_int8(x, (0, 1, 2, 3))  # one scale, batch too
        q_w, s_w = quantize_int8(weight, (1, 2, 3))  # (O, 1, 1, 1)
        acc = conv2d_int32(q_x, q_w, stride, padding)
        # contiguous NCHW: the sums are a channels-last view, and the next
        # GroupNorm (K6 on the card) takes contiguous NCHW only
        return (acc.float() * s_x * s_w.reshape(1, -1, 1, 1)).to(
            x.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        with torch.enable_grad():
            xe = x.detach().requires_grad_(True)
            we = weight.detach().requires_grad_(True)
            y = F.conv2d(xe, we, stride=stride, padding=padding)
            gx, gw = torch.autograd.grad(y, (xe, we), g.to(y.dtype))
        return gx, gw, None, None


def int8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ weight (N, K).T as W8A8, in x's dtype; no bias (the
    caller adds it after the cast, as flax does)."""
    return _Int8Linear.apply(x, weight)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """NCHW conv2d (no groups, no dilation, square stride and padding) as
    W8A8, in x's dtype, contiguous; no bias."""
    return _Int8Conv2d.apply(x, weight, int(stride), int(padding))
