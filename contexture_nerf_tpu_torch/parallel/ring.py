"""Ring attention over a sequence axis of the mesh; counterpart of
contexture_nerf_tpu/parallel/ring.py.

The Zero123++ reference attention doubles every self-attention's KV with
the condition image's tokens. Under optim.sequence_parallel each rank of
the `sp` axis takes its contiguous 1/n of the queries and of both KV
sources; the KV blocks rotate around the ring (point-to-point sends to the
next rank), each folded into an online-softmax state in f32, so no rank
attends over the whole concatenated KV at once. The output blocks are then
all-gathered, so every rank holds the whole output again: the towers
around the attention are replicated.

The local block product is plain torch in f32, as the reference's is a
plain einsum (not its Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from contexture_nerf_tpu_torch.parallel.mesh import (all_gather_cat,
                                                     axis_rank, axis_size,
                                                     block,
                                                     collective_counts)

_NEG_INF = -1e30


def _rotate(kc, vc, group, n, r):
    """Start sending (kc, vc) to the next rank of the ring and receiving
    the previous rank's; returns (requests, k, v) to wait on."""
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    nk, nv = torch.empty_like(kc), torch.empty_like(vc)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, kc, nxt, group),
        dist.P2POp(dist.isend, vc, nxt, group),
        dist.P2POp(dist.irecv, nk, prv, group),
        dist.P2POp(dist.irecv, nv, prv, group)])
    collective_counts["send_recv"] += 1
    return reqs, nk, nv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, seq_axis: str = "sp",
                   extra_k: Optional[torch.Tensor] = None,
                   extra_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, H, S, d) with the S axis split over the mesh's
    `seq_axis`. Every rank passes the whole q, k, v (and extra_k/extra_v,
    (B, H, Se, d), the second KV source attended jointly) and gets the whole
    output, in q's dtype. Applies 1/sqrt(d). Sq, Skv and Se must divide the
    axis size.

    Forward only: the SDS step's teacher output is stop-gradient, so no
    path differentiates through it; an input that requires grad raises."""
    B, H, S, d = q.shape
    n = axis_size(mesh, seq_axis)
    if S % n or k.shape[2] % n or (extra_k is not None
                                   and extra_k.shape[2] % n):
        raise ValueError(
            f"sequence axes must divide the '{seq_axis}' mesh axis ({n}): "
            f"Sq={S}, Skv={k.shape[2]}"
            + (f", Se={extra_k.shape[2]}" if extra_k is not None else ""))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, extra_k, extra_v)):
        raise ValueError("ring_attention has no backward: call it on "
                         "tensors that do not require grad")
    group = mesh.get_group(seq_axis)
    r = axis_rank(mesh, seq_axis)
    kc, vc = block(k, n, r, 2), block(v, n, r, 2)
    if extra_k is not None:
        kc = torch.cat([kc, block(extra_k, n, r, 2)], dim=2)
        vc = torch.cat([vc, block(extra_v, n, r, 2)], dim=2)
    kc, vc = kc.contiguous(), vc.contiguous()
    qf = block(q, n, r, 2).float() * (1.0 / d ** 0.5)
    o = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qf.shape[:3] + (1,), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    # n-1 rotations: the next block's transfer runs while this one is
    # folded in, and the last block is folded in without a rotation
    for step in range(n):
        pending = _rotate(kc, vc, group, n, r) if step < n - 1 else None
        s = torch.matmul(qf, kc.float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)  # noqa: E741
        o = o * corr + torch.matmul(p, vc.float())
        m = m_new
        if pending is not None:
            reqs, kc, vc = pending
            for req in reqs:
                req.wait()
    out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return all_gather_cat(out, group, dim=2)
