"""The port's attention (contexture_nerf_tpu_torch.ops.attention) against
the JAX reference: the flash kernel in interpret mode and `_xla_attention`,
f32 on the CPU, where the port's `flash_attention` runs its plain version.
Also: the port's dispatch routes the same shapes to the kernel as the
reference routes to Pallas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.ops.attention import (_xla_attention, attention as
                                               jax_attention,
                                               flash_attention_pallas,
                                               record_attention_calls)
from contexture_nerf_tpu_torch.ops import _build
from contexture_nerf_tpu_torch.ops import attention as att

ATOL = 2e-3  # as tests/test_diffusion.py holds the interpret kernel


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


CASES = {  # (q, kv, extra) lengths at B=1, H=2, d=64
    "single": (256, 300, 0),
    "two_source": (300, 700, 600),
    "short_kv": (256, 77, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_reference(case):
    sq, skv, se = CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 1, 2, s, 64) for s in (sq, skv, skv))
    ek, ev = ((_rand(rng, 1, 2, se, 64), _rand(rng, 1, 2, se, 64)) if se
              else (None, None))
    jx = [None if a is None else jnp.asarray(a) for a in (q, k, v, ek, ev)]
    ref_kernel = np.asarray(flash_attention_pallas(*jx, interpret=True))
    kc = np.concatenate([k, ek], 2) if se else k
    vc = np.concatenate([v, ev], 2) if se else v
    ref_xla = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc)))
    tq = [None if a is None else torch.from_numpy(a) for a in (q, k, v, ek, ev)]
    before = dict(_build.launch_counts)
    out = att.flash_attention(*tq)
    routed = att.attention(*tq)
    assert _build.launch_counts == before  # CPU tensors: plain version
    for got in (out, routed):
        np.testing.assert_allclose(got.numpy(), ref_kernel, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref_xla, atol=ATOL)


ROUTE_SHAPES = [  # (Sq, Skv, Se): the main path's and the rule's edges
    (1600, 1600, 0), (9600, 9600, 0), (2400, 2400, 0), (9600, 9600, 1600),
    (2400, 2400, 400), (600, 600, 100), (400, 400, 0), (9600, 77, 0),
    (255, 2048, 0), (256, 1024, 0), (256, 1023, 0), (256, 1000, 24),
    (256, 1000, 23),
]


@pytest.mark.parametrize("sq,skv,se", ROUTE_SHAPES)
def test_dispatch_routes_as_the_reference(sq, skv, se):
    def call(q, k, v, ek, ev):
        return jax_attention(q, k, v, ek, ev, use_pallas=True)

    s = jax.ShapeDtypeStruct
    args = (s((1, 1, sq, 64), jnp.bfloat16), s((1, 1, skv, 64), jnp.bfloat16),
            s((1, 1, skv, 64), jnp.bfloat16),
            s((1, 1, se, 64), jnp.bfloat16) if se else None,
            s((1, 1, se, 64), jnp.bfloat16) if se else None)
    with record_attention_calls([]) as calls:
        jax.eval_shape(call, *args)
    assert att.routes_to_kernel(sq, skv, se) == calls[0]["pallas"]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 1, 8, 64), dtype=torch.float32)
    with pytest.raises(ValueError):
        att._check("q", q, q)  # not on a CUDA device
