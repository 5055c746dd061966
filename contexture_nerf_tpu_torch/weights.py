"""Weight bridge: the JAX package's parameter trees -> the port's
`state_dict`s.

Inputs are flax variable trees as nested dicts of numpy arrays (for
example `jax.tree.map(np.asarray, params)`); this module needs neither JAX
nor flax. Port modules keep the flax names, so the mapping is mechanical:
  - a conv `kernel` (kh, kw, I, O) becomes `weight` (O, I, kh, kw);
  - a Dense `kernel` (in, out) becomes `weight` (out, in);
  - a LayerNorm / GroupNorm `scale` becomes `weight`; `bias` stays.
Values come out f32; `load_state_dict` casts them to the module's dtype.
A loader for diffusers checkpoints arrives with the `prepare_sds` slice.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def convert_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax module's variables ({"params": ...} or the bare tree) -> a
    torch state_dict with the same module path: NeRF2D -> models.fields.NeRF2D,
    UNet2DCondition -> diffusion.unet, ControlNet -> diffusion.controlnet,
    any layers.py block -> its port."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out = {}
    for path, arr in _leaves(tree):
        *mods, leaf = path.split(".")
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{path}: unexpected kernel rank {a.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{path}: unknown parameter kind {leaf!r}")
        out[".".join(mods + [leaf])] = torch.from_numpy(np.array(a))
    return out


def vae_encoder_state_dict(vae_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax AutoencoderKL variables -> diffusion.vae.Encoder (the encoder
    subtree; the decoder waits for its slice)."""
    tree = vae_params["params"] if "params" in vae_params else vae_params
    return convert_tree(tree["encoder"])


def load_teacher(teacher, zp_params: Mapping) -> None:
    """Zero123PlusPipeline.params (numpy tree with "unet", "controlnet",
    "vae") into a Zero123PlusTeacher."""
    teacher.unet.load_state_dict(convert_tree(zp_params["unet"]))
    teacher.controlnet.load_state_dict(convert_tree(zp_params["controlnet"]))
    teacher.vae_encoder.load_state_dict(
        vae_encoder_state_dict(zp_params["vae"]))
