"""Write the port's towers to disk as diffusers/transformers snapshots.

The counterpart of tools/synth_snapshot.py, which writes random state dicts
from the JAX package's configs; this one writes a port tower's own
parameters (seeded random towers, for example) under the diffusers and
transformers key names, through the name tables of diffusion/weights.py
read the other way, so that `diffusion.weights` loads them back bit for
bit:

    <sd_root>/unet/diffusion_pytorch_model.safetensors
    <sd_root>/vae/diffusion_pytorch_model.safetensors     encoder + decoder
    <sd_root>/text_encoder/model.safetensors
    <inpaint_root>/unet/diffusion_pytorch_model.safetensors
    <z123_root>/{unet,vae,text_encoder,vision_encoder}/... + model_index.json
    <controlnet_root>/diffusion_pytorch_model.safetensors

The Zero123++ teacher holds only the VAE's encoder, so its vae/ holds only
the encoder's keys. No tokenizer/ folder is written. Tensors are stored
F32 (a bf16 value widens to f32 exactly), written one at a time.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from contexture_nerf_tpu_torch.diffusion import weights as W

UNIT = "diffusion_pytorch_model.safetensors"
TRANSFORMERS_UNIT = "model.safetensors"


def save_safetensors(named: Iterable[Tuple[str, torch.Tensor]],
                     path: Path) -> int:
    """Write (name, tensor) pairs as an F32 safetensors file, one tensor
    copied to the host at a time. Returns the bytes written."""
    named = list(named)
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in named:
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, t in named:
            a = t.detach().to("cpu", torch.float32).contiguous().numpy()
            f.write(a.astype("<f4", copy=False).data)
    return 8 + len(blob) + offset


def _renamed(module: nn.Module, name_map, prefix: str = "",
             keep: Tuple[str, ...] = ()) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, t in module.state_dict().items():
        out.append((k if keep and k.startswith(keep) else
                    prefix + name_map(k), t))
    return out


def _names(table, config=None):
    n = len(config.block_out_channels) if config is not None else 0
    return W.NameMap(table, n, to_port=False)


def unet_tensors(unet):
    return _renamed(unet, _names(W.UNET_NAMES, unet.config))


def controlnet_tensors(controlnet):
    return _renamed(controlnet, _names(W.CONTROLNET_NAMES,
                                       controlnet.config))


def vae_tensors(vae_config, encoder=None, decoder=None):
    names = _names(W.VAE_NAMES, vae_config)
    out = []
    if encoder is not None:
        out += _renamed(encoder, names, "encoder.", ("quant_conv.",))
    if decoder is not None:
        out += _renamed(decoder, names, "decoder.", ("post_quant_conv.",))
    return out


def clip_text_tensors(text_encoder):
    return _renamed(text_encoder, _names(W.CLIP_TEXT_NAMES))


def clip_vision_tensors(vision_encoder):
    return _renamed(vision_encoder, _names(W.CLIP_VISION_NAMES))


def write_sd_snapshot(root, diffusion) -> int:
    """A StableDiffusionDepth's depth UNet, VAE and text tower as an
    SD2-depth snapshot (unet/, vae/, text_encoder/). Returns bytes."""
    root = Path(root)
    return (save_safetensors(unet_tensors(diffusion.unet),
                             root / "unet" / UNIT)
            + save_safetensors(vae_tensors(diffusion.vae_config,
                                           diffusion.vae_encoder,
                                           diffusion.vae_decoder),
                               root / "vae" / UNIT)
            + save_safetensors(clip_text_tensors(diffusion.text_encoder),
                               root / "text_encoder" / TRANSFORMERS_UNIT))


def write_inpaint_snapshot(root, diffusion) -> int:
    """A StableDiffusionDepth's inpaint UNet as an SD2-inpaint snapshot
    (unet/). Returns bytes."""
    return save_safetensors(unet_tensors(diffusion.inpaint_unet),
                            Path(root) / "unet" / UNIT)


def write_zero123plus_snapshot(root, teacher) -> int:
    """A Zero123PlusTeacher's UNet, VAE encoder and CLIP towers as a
    Zero123++ snapshot (unet/, vae/, text_encoder/, vision_encoder/), and
    its ramp in model_index.json. Returns bytes."""
    root = Path(root)
    n = (save_safetensors(unet_tensors(teacher.unet), root / "unet" / UNIT)
         + save_safetensors(vae_tensors(teacher.vae_config,
                                        teacher.vae_encoder),
                            root / "vae" / UNIT)
         + save_safetensors(clip_text_tensors(teacher.text_encoder),
                            root / "text_encoder" / TRANSFORMERS_UNIT)
         + save_safetensors(clip_vision_tensors(teacher.vision_encoder),
                            root / "vision_encoder" / TRANSFORMERS_UNIT))
    index = json.dumps({
        "_class_name": "Zero123PlusPipeline",
        "ramping_coefficients": [float(x) for x in np.asarray(
            teacher.ramping.cpu(), np.float32)]}).encode()
    (root / "model_index.json").write_bytes(index)
    return n + len(index)


def write_controlnet_snapshot(root, teacher) -> int:
    """A Zero123PlusTeacher's ControlNet as a standalone ControlNet
    directory. Returns bytes."""
    return save_safetensors(controlnet_tensors(teacher.controlnet),
                            Path(root) / UNIT)
