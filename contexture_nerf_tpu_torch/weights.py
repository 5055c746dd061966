"""Weight bridge: the JAX package's parameter trees -> the port's
`state_dict`s.

Inputs are flax variable trees as nested dicts of numpy arrays (for
example `jax.tree.map(np.asarray, params)`); this module needs neither JAX
nor flax. Port modules keep the flax names, so the mapping is mechanical:
  - a conv `kernel` (kh, kw, I, O) becomes `weight` (O, I, kh, kw);
  - a Dense `kernel` (in, out) becomes `weight` (out, in);
  - a LayerNorm / GroupNorm `scale` becomes `weight`; `bias` stays;
  - an nn.Embed `embedding` (num, features) becomes `weight` as it is;
  - raw parameters (CLIP's `position_embedding`, `class_embedding`) keep
    their names and layout.
Values come out f32; `load_state_dict` casts them to the module's dtype.
Diffusers and transformers checkpoints on disk load through
`diffusion/weights.py`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


RAW_PARAMS = ("position_embedding", "class_embedding")


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
    the CLIP towers -> diffusion.clip, any layers.py block -> its port."""
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
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf not in ("bias",) + RAW_PARAMS:
            raise ValueError(f"{path}: unknown parameter kind {leaf!r}")
        out[".".join(mods + [leaf])] = torch.from_numpy(np.array(a))
    return out


def vae_encoder_state_dict(vae_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax AutoencoderKL variables -> diffusion.vae.Encoder."""
    tree = vae_params["params"] if "params" in vae_params else vae_params
    return convert_tree(tree["encoder"])


def vae_decoder_state_dict(vae_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax AutoencoderKL variables -> diffusion.vae.Decoder."""
    tree = vae_params["params"] if "params" in vae_params else vae_params
    return convert_tree(tree["decoder"])


def load_teacher(teacher, zp_params: Mapping) -> None:
    """Zero123PlusPipeline.params (numpy tree with "unet", "controlnet",
    "vae" and, where given, the CLIP towers "text" and "vision") into a
    Zero123PlusTeacher, or into a Zero123PlusPipeline (its VAE decoder
    too)."""
    teacher.unet.load_state_dict(convert_tree(zp_params["unet"]))
    teacher.controlnet.load_state_dict(convert_tree(zp_params["controlnet"]))
    teacher.vae_encoder.load_state_dict(
        vae_encoder_state_dict(zp_params["vae"]))
    if hasattr(teacher, "vae_decoder"):
        teacher.vae_decoder.load_state_dict(
            vae_decoder_state_dict(zp_params["vae"]))
    for key, tower in (("text", teacher.text_encoder),
                       ("vision", teacher.vision_encoder)):
        if key in zp_params:
            tower.load_state_dict(convert_tree(zp_params[key]))


def load_sd_depth(diffusion, sd_params: Mapping) -> None:
    """StableDiffusionDepth.params (numpy tree with "unet", "inpaint_unet",
    "vae" and "text") into the port's StableDiffusionDepth."""
    diffusion.unet.load_state_dict(convert_tree(sd_params["unet"]))
    diffusion.inpaint_unet.load_state_dict(
        convert_tree(sd_params["inpaint_unet"]))
    diffusion.vae_encoder.load_state_dict(
        vae_encoder_state_dict(sd_params["vae"]))
    diffusion.vae_decoder.load_state_dict(
        vae_decoder_state_dict(sd_params["vae"]))
    diffusion.text_encoder.load_state_dict(convert_tree(sd_params["text"]))
