"""Attention: the flash-attention CUDA kernel (K3/K4), its plain version,
and the shape dispatch `attention()`.

Counterpart of contexture_nerf_tpu/ops/attention.py. The kernel
(csrc/flash_attn.cu) takes bf16 (B, H, S, 64) q/k/v and an optional second
KV source extra_k/extra_v (the Zero123++ reference-attention tokens) that
streams into the same online-softmax state, never concatenated. Calls that
the reference sends to its XLA einsum path go to plain matmul + softmax here,
as `_xla_attention` does.
"""

from __future__ import annotations

import ctypes

import torch

from contexture_nerf_tpu_torch.ops import _build

# The reference's routing rule (attention.py:305-307): the kernel only when
# Sq >= 256 and Skv + Se >= 1024. These thresholds were measured on a TPU;
# they are kept so the port launches the kernel where the reference
# launched Pallas. Retuning them for the H100 is later work.
MIN_SQ_KERNEL = 256
MIN_KV_KERNEL = 1024
HEAD_DIM = 64


def routes_to_kernel(sq: int, skv: int, se: int = 0) -> bool:
    """Whether `attention()` sends a call of these lengths to the kernel
    (on a CUDA device)."""
    return sq >= MIN_SQ_KERNEL and skv + se >= MIN_KV_KERNEL


def xla_attention_plain(q, k, v):
    """The reference's `_xla_attention`: f32 logits, softmax, probabilities
    cast to the input dtype, then P V."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, extra_k=None, extra_v=None):
    """Plain version of the kernel: concat the two KV sources, matmul and
    softmax (f32 logits and state, bf16 P, as the kernel rounds them)."""
    if extra_k is not None:
        k = torch.cat([k, extra_k], dim=2)
        v = torch.cat([v, extra_v], dim=2)
    return xla_attention_plain(q, k, v)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.flash_attn_fwd.restype = i
        _LIB = lib
    return _LIB


def _check(name, t, ref, s=None):
    if not t.is_cuda or t.device != ref.device:
        raise ValueError(f"{name} must be on {ref.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[0] != ref.shape[0] or t.shape[1] != ref.shape[1] \
            or t.shape[3] != HEAD_DIM:
        raise ValueError(f"{name} must be (B, H, S, {HEAD_DIM}) matching q; "
                         f"got {tuple(t.shape)}")
    if s is not None and t.shape[2] != s:
        raise ValueError(f"{name} length {t.shape[2]} != {s}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, extra_k=None, extra_v=None):
    """q (B,H,Sq,d), k/v (B,H,Skv,d), optional extra_k/extra_v (B,H,Se,d)
    attended jointly with k/v; 1/sqrt(d) applied inside. A CUDA tensor
    launches the kernel (bf16, d = 64) or raises; a CPU tensor takes the
    plain version."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"unsupported device {q.device}")
        return flash_attention_plain(q, k, v, extra_k, extra_v)
    if (extra_k is None) != (extra_v is None):
        raise ValueError("extra_k and extra_v go together")
    _check("q", q, q)
    _check("k", k, q)
    _check("v", v, q, k.shape[2])
    se = 0
    if extra_k is not None:
        _check("extra_k", extra_k, q)
        _check("extra_v", extra_v, q, extra_k.shape[2])
        se = extra_k.shape[2]
    B, H, sq, _ = q.shape
    if k.shape[2] == 0:
        raise ValueError("empty KV source")
    out = torch.empty_like(q)
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        extra_k.data_ptr() if se else None,
        extra_v.data_ptr() if se else None,
        out.data_ptr(), B * H, sq, k.shape[2], se,
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attn_fwd")
    _build.launch_counts["flash_attn_two_source" if se
                         else "flash_attn_single"] += 1
    return out


def attention(q, k, v, extra_k=None, extra_v=None):
    """Multi-head attention over (B, H, S, d) tensors, dispatched by shape as
    the reference does: the kernel for long sequences on the card, plain
    matmul + softmax (extra KV concatenated) otherwise."""
    se = 0 if extra_k is None else extra_k.shape[2]
    if q.is_cuda and routes_to_kernel(q.shape[2], k.shape[2], se):
        return flash_attention(q, k, v, extra_k, extra_v)
    return flash_attention_plain(q, k, v, extra_k, extra_v)
