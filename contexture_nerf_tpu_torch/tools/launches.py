"""The census: which of the port's hand kernels a run should launch, counted
from the calls the run makes.

Two kernels have a route to choose. Attention (K3/K4) launches the flash
kernel only for the calls that `ops.attention.routes_to_kernel` accepts and
that ring attention does not take under `sequence_parallel`; every other
call takes the plain route. GroupNorm(+SiLU) launches K6 once a call, and
`gn_bwd` once for each call whose backward runs. The other kernels (the MLP's
K1/K2, the rasterizer K5, the texture sampler K7) have no route: a CUDA
tensor launches them or raises.

`census()` watches the calls as they happen, by the keys of
`ops._build.launch_counts`, so a check holds what the wrappers launched on
the card to what the towers asked for, with no model of the towers:

    with census() as c:
        trainer.step(t)
    assert not c.unmatched(_build.launch_counts)

The counts do not depend on the device: on the CPU they are the calls that
would launch on the card. The program never imports this module; only the
card script and the tests do.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from contexture_nerf_tpu_torch.diffusion import clip, layers
from contexture_nerf_tpu_torch.ops import attention as att
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

KEYS = ("flash_attn_single", "flash_attn_two_source", "groupnorm",
        "groupnorm_bwd")

# The modules whose towers call `ops.attention.attention` by the name
# `attention`: the census wraps that name in each
# (tests/test_torch_launches.py holds this list to the package).
ATTENTION_SITES = (layers, clip)


class Census:
    """`counts[key]`: the calls of a census that route to kernel `key`;
    `head_dims[(key, d)]`: those of the attention keys by head dim d (K3 at
    64 and at 128); `calls`: the kernel-routed attention calls' (q, k, v,
    extra_k, extra_v) as the towers passed them, when kept."""

    def __init__(self, keep_calls: bool):
        self.counts: Dict[str, int] = dict.fromkeys(KEYS, 0)
        self.head_dims: Counter = Counter()
        self.calls: Optional[List[tuple]] = [] if keep_calls else None

    def unmatched(self, launches: Dict[str, int]
                  ) -> Dict[str, Tuple[int, int]]:
        """key -> (launched, census) for each key where `launches` (the
        wrappers' counts over the same calls) differs from the census."""
        return {k: (launches[k], n) for k, n in self.counts.items()
                if launches[k] != n}


@contextlib.contextmanager
def census(keep_calls: bool = False) -> Iterator[Census]:
    """Count, while active, every GroupNormSiLU call of any module (and
    those made with grad enabled whose input, scale or bias requires grad:
    their backward is gn_bwd's) and every attention call of the towers that
    routes to the flash kernel; keep the latter's inputs with
    `keep_calls`. A run that never calls backward launches no gn_bwd for the
    calls it counts."""
    c = Census(keep_calls)

    def groupnorm(mod, args):
        if isinstance(mod, GroupNormSiLU):
            c.counts["groupnorm"] += 1
            if torch.is_grad_enabled() and (
                    args[0].requires_grad or mod.weight.requires_grad
                    or mod.bias.requires_grad):
                c.counts["groupnorm_bwd"] += 1

    def routed(orig):
        def attention(q, k, v, extra_k=None, extra_v=None):
            se = 0 if extra_k is None else extra_k.shape[2]
            if att.routes_to_kernel(q.shape[2], k.shape[2], se) and \
                    not att._ring_eligible(q, k, extra_k):
                key = "flash_attn_two_source" if se else "flash_attn_single"
                c.counts[key] += 1
                c.head_dims[key, q.shape[-1]] += 1
                if c.calls is not None:
                    c.calls.append((q, k, v, extra_k, extra_v))
            return orig(q, k, v, extra_k=extra_k, extra_v=extra_v)
        return attention

    saved = [(m, m.attention) for m in ATTENTION_SITES]
    hook = torch.nn.modules.module.register_module_forward_pre_hook(groupnorm)
    for m, orig in saved:
        m.attention = routed(orig)
    try:
        yield c
    finally:
        hook.remove()
        for m, orig in saved:
            m.attention = orig
