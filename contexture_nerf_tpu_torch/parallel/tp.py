"""Tensor-parallel towers; counterpart of contexture_nerf_tpu/parallel/tp.py.

The reference's Megatron-style name rules: the Dense weights of to_q, to_k,
to_v, geglu_proj and linear_1 shard their output features (their biases
too), to_out, out_proj and linear_2 shard their input features, a 4-D conv
weight shards its output channels, and everything else, or a weight whose
sharded dimension the `tp` size does not divide, stays replicated.

In the JAX package these shardings are layout hints and GSPMD keeps the
function. Here each rank holds only its shard of a sharded parameter, and
the layer (diffusion/layers.py Dense / Conv, through `forward`) keeps the
function with explicit collectives over the `tp` group:
  - column (output-sharded) Dense or conv: its output slice, all-gathered
    along the feature or channel axis (so GEGLU's value / gate split sees
    the whole projection);
  - row (input-sharded) Dense: its slice of the input features times its
    weight shard, all-reduced in f32 (one rounding to the layer's dtype
    after the sum, as the unsharded product rounds once), the bias added
    once after the reduce.
Under W8A8 the scales are the unsharded layer's: an activation's row scale
over the whole input row, a row-sharded weight's per-output scale over
the whole row (kept at shard time); the row-sharded int32 sums are reduced
before the scales apply, so the quantized layer equals its replicated run.
Backward (the VAE encoder's, under the SDS loss): the gather keeps this
rank's slice of the replicated gradient, a column layer's input gradient
is all-reduced, and a row layer's is all-gathered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch.diffusion.layers import Conv, Dense
from contexture_nerf_tpu_torch.ops.quant import (int8_conv2d, int8_linear,
                                                 linear_int32, quantize_int8)
from contexture_nerf_tpu_torch.parallel.mesh import (all_gather_cat,
                                                     all_reduce_sum,
                                                     axis_rank, axis_size,
                                                     block, gather_rows)

# Dense weights (out, in): shard OUT features
COL_PARALLEL = ("to_q", "to_k", "to_v", "geglu_proj", "linear_1")
# Dense weights: shard IN features (they consume column-parallel outputs)
ROW_PARALLEL = ("to_out", "out_proj", "linear_2")


def _dim_for(name: str, p: torch.Tensor) -> Optional[int]:
    """The dimension of a torch parameter that the reference's rule shards
    (its `_spec_for` on the flax layout), or None."""
    parts = name.split(".")
    module = parts[-2] if len(parts) >= 2 else ""
    kind = parts[-1]
    if kind == "weight" and p.ndim == 2:
        if module in COL_PARALLEL:
            return 0
        if module in ROW_PARALLEL:
            return 1
        return None
    if kind == "weight" and p.ndim == 4:  # conv (O, I, kh, kw): shard O
        return 0
    if kind == "bias" and module in COL_PARALLEL:
        return 0
    return None


def tp_param_specs(module: nn.Module, mesh, axis: str = "tp") -> Dict:
    """{parameter name: Shard(dim) or Replicate()} by the reference's rules;
    a dimension the axis size does not divide stays replicated."""
    from torch.distributed.tensor import Replicate, Shard

    n = axis_size(mesh, axis)
    specs = {}
    for name, p in module.named_parameters():
        d = _dim_for(name, p)
        specs[name] = (Shard(d) if d is not None and p.shape[d] % n == 0
                       else Replicate())
    return specs


@dataclass
class TPShard:
    """A layer's place in the tp group: `kind` is "col" or "row"."""

    kind: str
    group: object
    n: int
    rank: int
    full_bias: Optional[torch.Tensor] = None  # a column conv's whole bias
    w_scale: Optional[torch.Tensor] = None  # a row Dense's W8A8 scales


def shard_params_tp(module: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Cut every Dense / Conv weight of `module` that tp_param_specs shards
    to this rank's contiguous block (the memory is freed) and mark the
    layer with its TPShard; other parameters stay whole. A layer already
    sharded is left as it is. Returns the module."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    specs = tp_param_specs(module, mesh, axis)
    for name, layer in module.named_modules():
        if not isinstance(layer, (Dense, Conv)) or \
                getattr(layer, "tp", None) is not None:
            continue
        spec = specs[f"{name}.weight" if name else "weight"]
        if not spec.is_shard():
            continue
        w = layer.weight.data
        kind = "row" if spec.dim == 1 else "col"
        shard = TPShard(kind, group, n, r)
        if kind == "row":
            shard.w_scale = quantize_int8(w, (1,))[1].reshape(-1)
        elif isinstance(layer, Conv) and layer.bias is not None:
            shard.full_bias = layer.bias  # replicated, as the reference
        layer.weight = nn.Parameter(block(w, n, r, spec.dim).clone(),
                                    requires_grad=layer.weight.requires_grad)
        if kind == "col" and isinstance(layer, Dense) and \
                layer.bias is not None:
            layer.bias = nn.Parameter(block(layer.bias.data, n, r).clone(),
                                      requires_grad=layer.bias.requires_grad)
        layer.tp = shard
    return module


def parameter_bytes(module: nn.Module) -> int:
    """Bytes of the parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in module.parameters())


def sharded_bytes(module: nn.Module, n: int) -> int:
    """Bytes of the parameters of an unsharded `module` that a rank would
    hold at tp = n, by the same rules."""
    total = 0
    for name, p in module.named_parameters():
        d = _dim_for(name, p)
        k = n if d is not None and p.shape[d] % n == 0 else 1
        total += p.numel() // k * p.element_size()
    return total


# -- the collectives of a sharded layer, with their backward -------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _SplitToTP(torch.autograd.Function):
    """This rank's block of the last axis; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.group = group
        return block(x, n, r, x.ndim - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, g.ndim - 1), None, None, None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _row_int8(x: torch.Tensor, weight: torch.Tensor, s: TPShard
              ) -> torch.Tensor:
    """W8A8 of a row-sharded Dense: q and scale of the whole activation
    row, this rank's slice of q times its weight shard quantized with the
    whole row's scales, the int32 sums reduced, then the scales."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("a W8A8 row-parallel Dense has no backward")
    q_x, s_x = quantize_int8(x, (-1,))
    q_w = torch.clamp(torch.round(weight.float() / s.w_scale[:, None]),
                      -127, 127).to(torch.int8)
    acc = linear_int32(block(q_x, s.n, s.rank, q_x.ndim - 1), q_w)
    acc = all_reduce_sum(acc.contiguous(), s.group)
    return (acc.float() * s_x * s.w_scale).to(x.dtype)


def dense_forward(layer, x: torch.Tensor) -> torch.Tensor:
    """A sharded Dense (x already in the layer's dtype)."""
    s: TPShard = layer.tp
    if s.kind == "col":
        x = _CopyToTP.apply(x, s.group)
        if not layer.quant:
            y = F.linear(x, layer.weight, layer.bias)
        else:
            y = int8_linear(x, layer.weight)
            y = y if layer.bias is None else y + layer.bias
        return gather_rows(y, s.group, y.ndim - 1)
    if layer.quant:
        y = _row_int8(x, layer.weight, s)
    else:
        part = F.linear(_SplitToTP.apply(x, s.group, s.n, s.rank),
                        layer.weight)
        y = _ReduceFromTP.apply(part.float(), s.group).to(x.dtype)
    return y if layer.bias is None else y + layer.bias


def conv_forward(layer, x: torch.Tensor) -> torch.Tensor:
    """A sharded (output-channel) Conv (x already in the layer's dtype)."""
    s: TPShard = layer.tp
    x = _CopyToTP.apply(x, s.group)
    bias = (None if s.full_bias is None
            else block(s.full_bias, s.n, s.rank))
    if layer.quant:
        y = int8_conv2d(x, layer.weight, layer.stride[0], layer.padding[0])
        if bias is not None:
            y = y + bias.reshape(1, -1, 1, 1)
    else:
        y = F.conv2d(x, layer.weight, bias, layer.stride, layer.padding)
    return gather_rows(y, s.group, 1).contiguous()
