"""2-D NeRF texture field: Fourier UV embedding + 8x256 skip-MLP.

Counterpart of contexture_nerf_tpu/models/fields.py (`embedder_out_dim`
lives beside the fused MLP in ops/mlp_kernel.py, which sizes its padded
embedding by it, and is taken from there). Layers keep the flax
names (`pts_linear_i`, `output_linear`) so weights.py maps them one to one;
nn.Linear keeps the torch layout (weight (out, in)).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from contexture_nerf_tpu_torch import resolve_device
from contexture_nerf_tpu_torch.ops.mlp_kernel import (embedder_out_dim,
                                                      fused_nerf2d)


def fourier_embed(x: torch.Tensor, multires: int = 10) -> torch.Tensor:
    """[x, sin(1x), cos(1x), sin(2x), cos(2x), ...] over the last dim."""
    outs = [x]
    for i in range(multires):
        f = float(2.0 ** i)
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


class NeRF2D(nn.Module):
    """8x256 ReLU MLP on the 42-dim embedding, 3 outputs; the input is
    concatenated as [emb, h] after layer 4 (the only configuration the
    reference instantiates, and the one the fused kernels take). Parameters
    f32, on `device` (the card unless the caller asks for the CPU)."""

    D, W, SKIP, INPUT_CH, OUTPUT_CH = 8, 256, 4, embedder_out_dim(10), 3

    def __init__(self, generator: torch.Generator = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        fan_in = self.INPUT_CH
        for i in range(self.D):
            setattr(self, f"pts_linear_{i}",
                    nn.Linear(fan_in, self.W, device=device))
            fan_in = self.W + (self.INPUT_CH if i == self.SKIP else 0)
        self.output_linear = nn.Linear(fan_in, self.OUTPUT_CH, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """kaiming-normal fan_in weights, uniform(+-1/sqrt(fan_in)) biases
        (the reference's torch init)."""
        for lin in self.linears():
            fan_in = lin.in_features
            std = (2.0 / fan_in) ** 0.5
            lin.weight.normal_(0.0, std, generator=generator)
            bound = 1.0 / fan_in ** 0.5
            lin.bias.uniform_(-bound, bound, generator=generator)

    def linears(self):
        return [getattr(self, f"pts_linear_{i}") for i in range(self.D)] + \
            [self.output_linear]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        inp = x
        for i in range(self.D):
            h = torch.relu(getattr(self, f"pts_linear_{i}")(h))
            if i == self.SKIP:
                h = torch.cat([inp, h], dim=-1)
        return self.output_linear(h)


def uv_lattice(res: int, device="cuda") -> torch.Tensor:
    """res^2 UV lattice: pixel (row i, col j) -> (u = j/(res-1),
    v = i/(res-1)). Returns (res*res, 2)."""
    lin = torch.linspace(0.0, 1.0, res, device=resolve_device(device))
    vv, uu = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([uu, vv], dim=-1).reshape(-1, 2)


def texture_from_mlp(mlp: NeRF2D, res: int, multires: int = 10,
                     compute_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query the MLP on the UV lattice -> ((1,3,res,res) texture in [0,1],
    raw mlp output (res*res, 3)); colors = (tanh + 1) / 2. Through the fused
    MLP: the kernel on a CUDA device, its plain version on the CPU."""
    uv = uv_lattice(res, device=mlp.output_linear.weight.device)
    mlp_output = fused_nerf2d(mlp, uv, multires, compute_dtype=compute_dtype)
    colors = (torch.tanh(mlp_output) + 1.0) / 2.0
    tex = colors.reshape(1, res, res, 3).permute(0, 3, 1, 2)
    return tex, mlp_output
