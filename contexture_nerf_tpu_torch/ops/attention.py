"""Attention: the flash-attention CUDA kernel (K3/K4), its plain version,
and the shape dispatch `attention()`.

Counterpart of contexture_nerf_tpu/ops/attention.py. The kernel
(csrc/flash_attn.cu) takes bf16 (B, H, S, 64) q/k/v and an optional second
KV source extra_k/extra_v (the Zero123++ reference-attention tokens) that
streams into the same online-softmax state, never concatenated. Calls that
the reference sends to its XLA einsum path go to plain matmul + softmax here,
as `_xla_attention` does. Under `sequence_parallel` the calls that the
reference's `_ring_eligible` takes go to ring attention over the mesh's
`sp` axis (parallel/ring.py) ahead of the kernel, as the reference's go
ahead of its Pallas kernel.
"""

from __future__ import annotations

import contextlib
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
KV_TILE = 128  # the kernel's keys a tile (BN); each source pads to it
BLOCK_M = (128, 192)  # the kernel's query rows a CTA; it picks by shape


# The sequence-parallel context: while a mesh is set, attention() sends
# eligible calls to ring attention over its `axis` (the reference's
# _SEQ_PARALLEL, set by the trainer around the SDS step's teacher call).
_SEQ_PARALLEL = {"mesh": None, "axis": "sp", "min_seq": 256}


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "sp", min_seq: int = 256):
    """Route the eligible attention() calls in this block through ring
    attention over `axis` of `mesh`."""
    prev = dict(_SEQ_PARALLEL)
    _SEQ_PARALLEL.update(mesh=mesh, axis=axis, min_seq=min_seq)
    try:
        yield
    finally:
        _SEQ_PARALLEL.update(prev)


def ring_eligible_lengths(sq: int, skv: int, se: int, n: int,
                          min_seq: int = 256) -> bool:
    """The reference's rule: Sq >= min_seq, and Sq, Skv and Se (when
    there is a second source) divisible by the axis size n."""
    return sq >= min_seq and sq % n == 0 and skv % n == 0 and se % n == 0


def _ring_eligible(q, k, extra_k) -> bool:
    mesh = _SEQ_PARALLEL["mesh"]
    if mesh is None:
        return False
    from contexture_nerf_tpu_torch.parallel.mesh import axis_size

    n = axis_size(mesh, _SEQ_PARALLEL["axis"])
    se = 0 if extra_k is None else extra_k.shape[2]
    return ring_eligible_lengths(q.shape[2], k.shape[2], se, n,
                                 _SEQ_PARALLEL["min_seq"])


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
_STRIDES = ctypes.c_longlong * 18  # (batch, head, row) of q, k, v, ek, ev, o


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, i,
                                       p]
        lib.flash_attn_fwd.restype = i
        _LIB = lib
    return _LIB


def _check(name, t, ref, s=None):
    """Raise unless t is what the kernel takes beside q = ref: on ref's CUDA
    device, bf16, (B, H, S, 64) with ref's B and H (and length s), rows of
    64 contiguous elements, the other strides whole 16-byte units and the
    base 16-byte aligned (the TMA tensor maps' terms). Returns its (batch,
    head, row) strides in elements; a dimension of size 1 is never stepped
    over and gets a stand-in."""
    shape, st = t.shape, t.stride()
    if not t.is_cuda or t.device != ref.device:
        raise ValueError(f"{name} must be on {ref.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if len(shape) != 4 or shape[0] != ref.shape[0] \
            or shape[1] != ref.shape[1] or shape[3] != HEAD_DIM:
        raise ValueError(f"{name} must be (B, H, S, {HEAD_DIM}) matching q; "
                         f"got {tuple(shape)}")
    if s is not None and shape[2] != s:
        raise ValueError(f"{name} length {shape[2]} != {s}")
    out = [st[i] if shape[i] > 1 else HEAD_DIM for i in range(3)]
    if st[3] != 1 or out[0] % 8 or out[1] % 8 or out[2] % 8 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must have a last stride of 1, other strides "
                         f"multiples of 8 elements and a 16-byte aligned "
                         f"base; got strides {st}")
    return out


def flash_attention(q, k, v, extra_k=None, extra_v=None, block_m=0):
    """q (B,H,Sq,d), k/v (B,H,Skv,d), optional extra_k/extra_v (B,H,Se,d)
    attended jointly with k/v; 1/sqrt(d) applied inside. A CUDA tensor
    launches the kernel (bf16, d = 64, any strides `_check` takes) or
    raises; a CPU tensor takes the plain version. On the card the output is
    a (B,H,Sq,d) view of (B,Sq,H,d) memory, so the heads merge back into
    the projection's layout for free. block_m: the kernel's query rows a
    CTA, one of BLOCK_M; 0 picks by shape (the tile sweep sets it)."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"unsupported device {q.device}")
        return flash_attention_plain(q, k, v, extra_k, extra_v)
    if (extra_k is None) != (extra_v is None):
        raise ValueError("extra_k and extra_v go together")
    B, H, sq, _ = q.shape
    skv = k.shape[2]
    if skv == 0:
        raise ValueError("empty KV source")
    strides = _check("q", q, q) + _check("k", k, q) + _check("v", v, q, skv)
    se = 0
    if extra_k is not None:
        se = extra_k.shape[2]
        strides += _check("extra_k", extra_k, q) + _check(
            "extra_v", extra_v, q, se)
    else:
        strides += strides[3:9]  # stand-ins, never read
    out = torch.empty((B, sq, H, HEAD_DIM), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    strides += [sq * H * HEAD_DIM, HEAD_DIM, H * HEAD_DIM]
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        extra_k.data_ptr() if se else None,
        extra_v.data_ptr() if se else None,
        out.data_ptr(), B, H, sq, skv, se, _STRIDES(*strides), block_m,
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attn_fwd")
    _build.count_launch("flash_attn_two_source" if se
                        else "flash_attn_single", B, H, sq, skv, se)
    return out


def attention(q, k, v, extra_k=None, extra_v=None):
    """Multi-head attention over (B, H, S, d) tensors, dispatched by shape as
    the reference does: ring attention for the eligible calls under
    `sequence_parallel`, then the kernel for long sequences on the card,
    plain matmul + softmax (extra KV concatenated) otherwise."""
    if _ring_eligible(q, k, extra_k):
        from contexture_nerf_tpu_torch.parallel.ring import ring_attention

        return ring_attention(q, k, v, _SEQ_PARALLEL["mesh"],
                              _SEQ_PARALLEL["axis"], extra_k, extra_v)
    se = 0 if extra_k is None else extra_k.shape[2]
    if q.is_cuda and routes_to_kernel(q.shape[2], k.shape[2], se):
        return flash_attention(q, k, v, extra_k, extra_v)
    return flash_attention_plain(q, k, v, extra_k, extra_v)
