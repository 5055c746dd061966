"""Seeded weights, made by the benchmark on the device in a few large calls
and handed to the program and to the reference alike.

A tower's parameter list (names and shapes, the same in the program's
module and the reference's) is split by kind: biases are zero, norm scales
one, every other leaf N(0, 1 / fan_in) (fan_in: the product of the shape
past its first axis), as the program's own random init fills towers that
have no checkpoint. Each kind, and each fan_in of the random leaves, is one
flat buffer drawn in one call from a generator seeded by the run's seed and
the tower's name; the leaves are views into those buffers, 64-element
aligned. The texture MLP's leaves follow its published init: kaiming-normal
weights and uniform(+-1/sqrt(fan_in)) biases, f32.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

ALIGN = 64


def tower_seed(seed: int, tower: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{tower}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def kind(name: str, shape: Sequence[int]) -> Tuple[str, int]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "zeros", 0
    if "norm" in name:
        return "ones", 0
    return "normal", math.prod(shape[1:] if len(shape) > 1 else shape)


def spec(module: nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def _pad(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def make_tower(leaves: List[Tuple[str, Tuple[int, ...]]], seed: int,
               tower: str, device, dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for a tower's leaves, as described above."""
    gen = torch.Generator(device=device).manual_seed(tower_seed(seed, tower))
    groups: Dict[Tuple[str, int], List[Tuple[str, Tuple[int, ...]]]] = {}
    for name, shape in leaves:
        groups.setdefault(kind(name, shape), []).append((name, shape))
    out = {}
    for (k, fan_in) in sorted(groups):
        members = groups[(k, fan_in)]
        total = sum(_pad(math.prod(s)) for _, s in members)
        if k == "zeros":
            flat = torch.zeros(total, device=device, dtype=dtype)
        elif k == "ones":
            flat = torch.ones(total, device=device, dtype=dtype)
        else:
            flat = torch.randn(total, generator=gen, device=device,
                               dtype=dtype)
            flat.mul_(fan_in ** -0.5)
        off = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += _pad(n)
    return out


def make_mlp(leaves: List[Tuple[str, Tuple[int, ...]]], seed: int, device
             ) -> Dict[str, torch.Tensor]:
    """The texture MLP's f32 leaves: weights N(0, 2 / fan_in), biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in the layer's input width."""
    gen = torch.Generator(device=device).manual_seed(tower_seed(seed, "mlp"))
    weights = [(n, s) for n, s in leaves if n.endswith("weight")]
    biases = [(n, s) for n, s in leaves if n.endswith("bias")]
    fan = {n.rsplit(".", 1)[0]: s[1] for n, s in weights}
    wn = torch.randn(sum(math.prod(s) for _, s in weights), generator=gen,
                     device=device)
    bu = torch.rand(sum(math.prod(s) for _, s in biases), generator=gen,
                    device=device)
    out, off = {}, 0
    for n, s in weights:
        k = math.prod(s)
        out[n] = (wn[off:off + k] * (2.0 / fan[n.rsplit(".", 1)[0]]) ** 0.5
                  ).view(s)
        off += k
    off = 0
    for n, s in biases:
        k = math.prod(s)
        bound = fan[n.rsplit(".", 1)[0]] ** -0.5
        out[n] = ((bu[off:off + k] * 2 - 1) * bound).view(s)
        off += k
    return out


def install(module: nn.Module, tensors: Dict[str, torch.Tensor],
            requires_grad: bool = False, dtype=None) -> None:
    """Put the given tensors in place of the module's parameters (a module
    built on the meta device gets real storage this way); names must match
    the module's exactly."""
    names = [n for n, _ in module.named_parameters()]
    if sorted(names) != sorted(tensors):
        missing = set(names) ^ set(tensors)
        raise KeyError(f"parameter names differ: {sorted(missing)[:5]}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        t = tensors[name]
        if dtype is not None:
            t = t.to(dtype)
        old = getattr(mod, leaf)
        if tuple(old.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(old.shape)}")
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=requires_grad)
