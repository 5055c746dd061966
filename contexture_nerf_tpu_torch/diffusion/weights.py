"""Diffusers/transformers checkpoints -> the port's towers; the counterpart of
contexture_nerf_tpu/diffusion/weights.py.

A checkpoint is a local directory (or file) in the diffusers layout:
`diffusion_pytorch_model.safetensors`, `model.safetensors`, or the `.bin`
names. Safetensors files are read by the reader below (an 8-byte
little-endian header length, a JSON header of `dtype`, `shape` and
`data_offsets`, then the raw bytes), so no `safetensors` package is needed.

The checkpoints are in torch layout already, so unlike the JAX converter
nothing is transposed: `convert_*` only rename the diffusers and
transformers keys onto the port modules' own (flax) names through one name
table per tower, which `tools/synth_snapshot.py` reads the other way.
`load_tower_` copies a converted checkpoint into a module one tensor at a
time (each tensor memory-mapped, cast and copied to the module's device and
dtype), as strictly as `load_state_dict(strict=True)`: a key missing or
left over, or a shape that differs, raises before anything is copied.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

CHECKPOINT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                    "diffusion_pytorch_model.bin", "pytorch_model.bin")
SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16}


# -- the safetensors format ----------------------------------------------------------

def safetensors_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the tensors' entries by name, the byte offset of the data)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        n = int.from_bytes(head, "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensor(path: str, entry: dict, data_start: int) -> np.ndarray:
    """One tensor of a safetensors file, memory-mapped (copy-on-write: the
    file is never written)."""
    dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"{path}: dtype {entry['dtype']} is not read "
                         f"(only {sorted(SAFETENSORS_DTYPES)})")
    begin, end = entry["data_offsets"]
    shape = tuple(entry["shape"])
    if end - begin != int(np.prod(shape)) * np.dtype(dtype).itemsize:
        raise ValueError(f"{path}: data_offsets {entry['data_offsets']} do "
                         f"not hold {entry['dtype']} {list(shape)}")
    if end == begin:
        return np.zeros(shape, dtype)
    return np.memmap(path, dtype=dtype, mode="c", offset=data_start + begin,
                     shape=shape)


# -- checkpoints -------------------------------------------------------------------

def resolve_checkpoint(path: str) -> str:
    """A checkpoint directory -> its weights file, by the names diffusers
    and transformers write (the first that exists); a file stays itself."""
    path = str(path)
    if os.path.isdir(path):
        for name in CHECKPOINT_NAMES:
            p = os.path.join(path, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"{path}: no checkpoint file (looked for {CHECKPOINT_NAMES})")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no such checkpoint")
    return path


class Checkpoint(Mapping):
    """A state dict on disk: name -> CPU tensor in the file's dtype, each
    read when asked for. Safetensors files are memory-mapped a tensor at a
    time; `.bin` files load with torch.load(weights_only=True, mmap=True)
    and a "state_dict" key is unwrapped."""

    def __init__(self, path: str):
        self.path = resolve_checkpoint(path)
        self._tensors = None
        if self.path.endswith(".safetensors"):
            self._header, self._start = safetensors_header(self.path)
        else:
            sd = torch.load(self.path, map_location="cpu",
                            weights_only=True, mmap=True)
            if "state_dict" in sd:
                sd = sd["state_dict"]
            self._tensors = sd

    def shape(self, name: str) -> Tuple[int, ...]:
        if self._tensors is not None:
            return tuple(self._tensors[name].shape)
        return tuple(self._header[name]["shape"])

    def __getitem__(self, name: str) -> torch.Tensor:
        if self._tensors is not None:
            return self._tensors[name]
        return torch.from_numpy(read_safetensor(
            self.path, self._header[name], self._start))

    def __iter__(self) -> Iterator[str]:
        return iter(self._tensors if self._tensors is not None
                    else self._header)

    def __len__(self) -> int:
        return len(self._tensors if self._tensors is not None
                   else self._header)


def snapshot_tokenizer(root) -> Tuple[Optional[str], Optional[str]]:
    """(vocab.json, merges.txt) of a snapshot's tokenizer/ folder when it
    holds both, else (None, None)."""
    vocab = os.path.join(root, "tokenizer", "vocab.json")
    merges = os.path.join(root, "tokenizer", "merges.txt")
    if os.path.exists(vocab) and os.path.exists(merges):
        return vocab, merges
    return None, None


def load_state_dict(path: str) -> Checkpoint:
    """A checkpoint directory or file -> its tensors by name (read lazily)."""
    return Checkpoint(path)


# -- name tables: (diffusers/transformers name, port name) ------------------------------
# "{i}"-style fields are indices; "{u}" is an up-block index, which
# diffusers counts from the deepest block and the port from the shallowest.

_RESNETS = (
    ("down_blocks.{b}.resnets.{l}", "down_{b}_resnet_{l}"),
    ("down_blocks.{b}.downsamplers.0.conv", "down_{b}_downsample.conv"),
    ("mid_block.resnets.{l}", "mid_resnet_{l}"),
    ("up_blocks.{u}.resnets.{l}", "up_{u}_resnet_{l}"),
    ("up_blocks.{u}.upsamplers.0.conv", "up_{u}_upsample.conv"),
)
_ATTENTION = (
    ("down_blocks.{b}.attentions.{l}", "down_{b}_attn_{l}"),
    ("mid_block.attentions.0", "mid_attn"),
    ("up_blocks.{u}.attentions.{l}", "up_{u}_attn_{l}"),
    ("transformer_blocks.{i}", "transformer_blocks_{i}"),
    ("to_out.0", "to_out"),
    ("ff.net.0.proj", "ff.geglu_proj"),
    ("ff.net.2", "ff.out_proj"),
)
UNET_NAMES = _RESNETS + _ATTENTION
CONTROLNET_NAMES = UNET_NAMES + (
    ("controlnet_cond_embedding.blocks.{i}",
     "controlnet_cond_embedding.blocks_{i}"),
    ("controlnet_down_blocks.{i}", "controlnet_down_blocks_{i}"),
)
# inside `encoder.` / `decoder.`; the legacy attention names read only
VAE_NAMES = _RESNETS + (("mid_block.attentions.0", "mid_attn"),
                        ("to_out.0", "to_out"))
VAE_LEGACY_NAMES = (("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
                    ("proj_attn", "to_out"))
_CLIP_LAYER = tuple((f"self_attn.{p}", p) for p in
                    ("q_proj", "k_proj", "v_proj", "out_proj")) + (
    ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"))
CLIP_TEXT_NAMES = (
    ("text_model.embeddings.token_embedding", "token_embedding"),
    ("text_model.embeddings.position_embedding.weight", "position_embedding"),
    ("text_model.final_layer_norm", "final_layer_norm"),
    ("text_model.encoder.layers.{i}", "layers_{i}"),
) + _CLIP_LAYER
CLIP_VISION_NAMES = (
    ("vision_model.embeddings.patch_embedding", "patch_embedding"),
    ("vision_model.embeddings.class_embedding", "class_embedding"),
    ("vision_model.embeddings.position_embedding.weight",
     "position_embedding"),
    ("vision_model.pre_layrnorm", "pre_layrnorm"),
    ("vision_model.post_layernorm", "post_layernorm"),
    ("vision_model.encoder.layers.{i}", "layers_{i}"),
) + _CLIP_LAYER
# transformers' position-id buffers (persistent before transformers 4.31):
# an arange, not a weight, and no port module has them
CLIP_DROPPED = ("text_model.embeddings.position_ids",
                "vision_model.embeddings.position_ids")


def _pattern(template: str) -> "re.Pattern":
    body = re.sub(r"\\\{(\w)\\\}", r"(?P<\1>\\d+)", re.escape(template))
    return re.compile(body + r"(?=\.|$)")


class NameMap:
    """A name table read in one direction: rewrites a dotted name segment
    by segment, the first matching entry at each position; `n_up` is the
    number of UNet/VAE blocks for the up-block flip."""

    def __init__(self, table, n_up: int = 0, to_port: bool = True):
        pairs = table if to_port else [(p, h) for h, p in table]
        self.rules = [(_pattern(src), dst) for src, dst in pairs]
        self.n_up = n_up

    def __call__(self, name: str) -> str:
        segs, out, i = name.split("."), [], 0
        while i < len(segs):
            rest = ".".join(segs[i:])
            for pat, dst in self.rules:
                m = pat.match(rest)
                if m:
                    fields = {k: int(v) for k, v in m.groupdict().items()}
                    if "u" in fields:
                        fields["u"] = self.n_up - 1 - fields["u"]
                    out.append(dst.format(**fields))
                    i += m.group(0).count(".") + 1
                    break
            else:
                out.append(segs[i])
                i += 1
        return ".".join(out)


class Converted(Mapping):
    """A Checkpoint seen under the port's names: port name -> the
    checkpoint's tensor, still read lazily."""

    def __init__(self, sd: Checkpoint, names: Dict[str, str]):
        self.sd, self.names = sd, names  # port name -> checkpoint name

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.sd.shape(self.names[name])

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.sd[self.names[name]]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


def _convert(sd: Checkpoint, name_map, keys=None) -> Converted:
    names = {}
    for k in (sd if keys is None else keys):
        port = name_map(k)
        if port in names:
            raise ValueError(f"{k} and {names[port]} both map to {port}")
        names[port] = k
    return Converted(sd, names)


def convert_unet(sd: Checkpoint, config) -> Converted:
    """diffusers UNet2DConditionModel -> diffusion.unet.UNet2DCondition."""
    return _convert(sd, NameMap(UNET_NAMES, len(config.block_out_channels)))


def convert_controlnet(sd: Checkpoint, config) -> Converted:
    """diffusers ControlNetModel -> diffusion.controlnet.ControlNet."""
    return _convert(sd, NameMap(CONTROLNET_NAMES,
                                len(config.block_out_channels)))


def convert_vae(sd: Checkpoint, config) -> Dict[str, Converted]:
    """diffusers AutoencoderKL -> {"encoder": diffusion.vae.Encoder's,
    "decoder": diffusion.vae.Decoder's}. `quant_conv` belongs to the
    encoder and `post_quant_conv` to the decoder, as in the port's modules;
    a part the file does not hold comes out empty. A key of neither part
    raises."""
    n = len(config.block_out_channels)
    name_map = NameMap(VAE_NAMES + VAE_LEGACY_NAMES, n)
    parts = {"encoder": [], "decoder": []}
    for k in sd:
        if k.startswith(("encoder.", "quant_conv.")):
            parts["encoder"].append(k)
        elif k.startswith(("decoder.", "post_quant_conv.")):
            parts["decoder"].append(k)
        else:
            raise ValueError(f"{k}: neither the VAE's encoder nor decoder")
    return {part: _convert(sd, lambda k, p=part: name_map(
        k[len(p) + 1:] if k.startswith(p + ".") else k), keys)
        for part, keys in parts.items()}


def convert_clip_text(sd: Checkpoint, config=None) -> Converted:
    """transformers CLIPTextModel -> diffusion.clip.CLIPTextModel."""
    return _convert(sd, NameMap(CLIP_TEXT_NAMES),
                    [k for k in sd if k not in CLIP_DROPPED])


def convert_clip_vision(sd: Checkpoint, config=None) -> Converted:
    """transformers CLIPVisionModelWithProjection ->
    diffusion.clip.CLIPVisionModelWithProjection."""
    return _convert(sd, NameMap(CLIP_VISION_NAMES),
                    [k for k in sd if k not in CLIP_DROPPED])


# -- loading into a module -------------------------------------------------------------

@torch.no_grad()
def load_tower_(module: nn.Module, converted: Converted) -> int:
    """Copy `converted` (port name -> tensor) into `module`'s parameters and
    buffers, cast to each one's dtype on its device, one tensor at a time.
    Strict: a key missing or left over, or a shape that differs, raises
    before anything is copied. Returns the bytes read."""
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(converted))
    unexpected = sorted(set(converted) - set(own))
    wrong = [f"{k}: checkpoint {list(converted.shape(k))}, module "
             f"{list(own[k].shape)}" for k in own
             if k in converted and converted.shape(k) != tuple(own[k].shape)]
    if missing or unexpected or wrong:
        lines: List[str] = []
        if missing:
            lines.append(f"missing keys {missing}")
        if unexpected:
            lines.append(f"unexpected keys {unexpected}")
        if wrong:
            lines.append(f"shape mismatches {wrong}")
        raise RuntimeError(f"loading {type(module).__name__}: "
                           + "; ".join(lines))
    nbytes = 0
    for k, dst in own.items():
        src = converted[k]
        dst.data.copy_(src)
        nbytes += src.numel() * src.element_size()
        del src
    return nbytes


def load_checkpoint_(module: nn.Module, path: str, convert, config=None,
                     part: Optional[str] = None) -> int:
    """load_tower_(module, convert(load_state_dict(path), config)[part]);
    returns the bytes read."""
    converted = convert(load_state_dict(path), config)
    if part is not None:
        converted = converted[part]
    return load_tower_(module, converted)


def load_towers_(loads) -> Dict[str, dict]:
    """`load_checkpoint_` for each (name, module, path, convert, config[,
    part]) whose path is set, timed on the host clock with the module's
    device synchronised at both ends. Returns {name: {"path", "bytes",
    "seconds"}}."""
    out = {}
    for name, module, path, convert, config, *part in loads:
        if not path:
            continue
        dev = next(module.parameters()).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = load_checkpoint_(module, path, convert, config, *part)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = {"path": str(path), "bytes": n,
                     "seconds": time.perf_counter() - t0}
    return out
