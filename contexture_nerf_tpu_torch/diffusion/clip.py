"""CLIP text and vision towers and the CLIP tokenizer; the port's
counterparts of contexture_nerf_tpu/diffusion/clip.py (`CLIPTextModel`,
`CLIPVisionModelWithProjection`, `CLIPTokenizer`).

Modules keep the flax names (`layers_0`, `q_proj`, `token_embedding`,
`position_embedding`, ...) so weights.py maps a flax tree onto them. As in
the reference: LayerNorms compute in f32, GELU is the exact erf form (the
transformers "gelu"), the text tower is causal with a -1e30 mask, and the
vision tower's self-attention goes through `ops.attention.attention` (at
257 tokens the routing rule sends it to the plain path).

The tokenizer loads a CLIP vocab.json / merges.txt pair when given local
paths; otherwise a deterministic hash tokenizer with the same id range and
special-token layout stands in. Textual-inversion tokens (`add_token`) map
a literal token to a row appended to the text tower's table
(`CLIPTextModel.grow_tokens`), as the reference's `load_concept` does.
"""

from __future__ import annotations

import hashlib
import html
import json
import math
import os
import re
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from contexture_nerf_tpu_torch.diffusion.layers import (Conv, Dense,
                                                        LayerNormF32)
from contexture_nerf_tpu_torch.ops.attention import attention


class CLIPTextConfig:
    def __init__(self, vocab_size=49408, hidden_size=1024, num_layers=23,
                 num_heads=16, intermediate_size=4096, max_positions=77):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_positions = max_positions

    @staticmethod
    def sd2():
        """OpenCLIP ViT-H text tower of SD2: 23 x 1024, 16 heads."""
        return CLIPTextConfig()

    @staticmethod
    def tiny():
        return CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                              num_heads=2, intermediate_size=64)


class CLIPVisionConfig:
    def __init__(self, hidden_size=1280, num_layers=32, num_heads=16,
                 intermediate_size=5120, image_size=224, patch_size=14,
                 projection_dim=1024):
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.image_size = image_size
        self.patch_size = patch_size
        self.projection_dim = projection_dim

    @staticmethod
    def vit_h():
        """OpenCLIP ViT-H/14, the Zero123++ vision encoder (224 px, patch
        14, image_embeds dim 1024)."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny():
        return CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=2,
                                intermediate_size=64, image_size=32,
                                patch_size=8, projection_dim=32)


class CLIPLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 causal: bool, dtype=torch.float32):
        super().__init__()
        self.hidden, self.heads, self.causal = hidden, heads, causal
        self.dtype = dtype
        self.layer_norm1 = LayerNormF32(hidden)
        self.q_proj = Dense(hidden, hidden)
        self.k_proj = Dense(hidden, hidden)
        self.v_proj = Dense(hidden, hidden)
        self.out_proj = Dense(hidden, hidden)
        self.layer_norm2 = LayerNormF32(hidden)
        self.fc1 = Dense(hidden, intermediate)
        self.fc2 = Dense(intermediate, hidden)

    def forward(self, x):
        h = self.layer_norm1(x).to(self.dtype)
        B, S, _ = h.shape
        hd = self.hidden // self.heads

        def split(t):
            return t.reshape(B, S, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(h)), split(self.k_proj(h)), \
            split(self.v_proj(h))
        if self.causal:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * (1.0 / math.sqrt(hd))
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()
            logits = torch.where(mask, logits, torch.tensor(
                -1e30, device=x.device))
            probs = torch.softmax(logits, dim=-1).to(self.dtype)
            o = torch.matmul(probs, v)
        else:
            o = attention(q.contiguous(), k.contiguous(), v.contiguous())
        o = o.transpose(1, 2).reshape(B, S, self.hidden)
        x = x + self.out_proj(o)
        h = self.layer_norm2(x).to(self.dtype)
        h = self.fc2(F.gelu(self.fc1(h)))  # the exact erf GELU
        return x + h


class CLIPTextModel(nn.Module):
    """(B, S) token ids -> (B, S, hidden) final hidden states (f32)."""

    def __init__(self, config: CLIPTextConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden_size))
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                causal=True, dtype=dtype))
        self.final_layer_norm = LayerNormF32(cfg.hidden_size)

    @torch.no_grad()
    def grow_tokens(self, rows: torch.Tensor) -> int:
        """Append rows (k, hidden) to the token table (transformers'
        resize_token_embeddings plus the new rows); the config's vocab_size
        follows. Returns the first new row's id."""
        old = self.token_embedding.weight
        first = old.shape[0]
        table = nn.Embedding(first + rows.shape[0], old.shape[1],
                             device=old.device, dtype=old.dtype)
        table.weight.copy_(torch.cat([old, rows.to(old)]))
        table.requires_grad_(old.requires_grad)
        self.token_embedding = table
        self.config.vocab_size = table.num_embeddings
        return first

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(input_ids).to(self.dtype)
        x = x + self.position_embedding[None, :input_ids.shape[1]].to(
            self.dtype)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.final_layer_norm(x)


class CLIPVisionModelWithProjection(nn.Module):
    """(B, 3, H, W) normalized pixels -> image_embeds (B, projection_dim)."""

    def __init__(self, config: CLIPVisionConfig, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        p = cfg.patch_size
        n_tokens = (cfg.image_size // p) ** 2 + 1
        self.patch_embedding = Conv(3, cfg.hidden_size, p, stride=p,
                                    bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(n_tokens, cfg.hidden_size))
        self.pre_layrnorm = LayerNormF32(cfg.hidden_size)
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                causal=False, dtype=dtype))
        self.post_layernorm = LayerNormF32(cfg.hidden_size)
        self.visual_projection = Dense(cfg.hidden_size, cfg.projection_dim,
                                       bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values)  # (B, C, gh, gw)
        B, C = x.shape[:2]
        patches = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C)
        cls = self.class_embedding.to(self.dtype).expand(B, 1, C)
        h = torch.cat([cls, patches], dim=1)
        h = h + self.position_embedding[None].to(self.dtype)
        h = self.pre_layrnorm(h).to(self.dtype)
        for i in range(self.config.num_layers):
            h = getattr(self, f"layers_{i}")(h)
        pooled = self.post_layernorm(h[:, 0])
        return self.visual_projection(pooled.to(self.dtype))


class CLIPTokenizer:
    """CLIP BPE tokenizer (local vocab.json + merges.txt) with a hash
    fallback. `__call__` pads to max_length with eos: [bos, ids..., eos,
    eos, ...] as int32 (N, max_length). `vocab_size` (and with it bos, eos
    and the hash fallback's range) stays what it was built with when
    tokens are added."""

    def __init__(self, vocab_path: Optional[str] = None,
                 merges_path: Optional[str] = None,
                 vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.added_tokens: dict = {}
        self._bpe = False
        if vocab_path and os.path.exists(vocab_path):
            self._load_bpe(vocab_path, merges_path)

    def add_token(self, token: str, token_id: int) -> None:
        """Map a literal token (a textual-inversion concept's) to a fixed
        id."""
        self.added_tokens[token.lower()] = token_id

    def _load_bpe(self, vocab_path, merges_path):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        with open(merges_path) as f:
            merges = f.read().split("\n")[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._bpe = True

    def _bpe_word(self, token: str) -> List[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = html.unescape(text.strip().lower())
        # an added token stands apart even next to punctuation ("<sks>.");
        # the longest first, where one added token prefixes another
        for tok in sorted(self.added_tokens, key=len, reverse=True):
            if tok in text:
                text = text.replace(tok, f" {tok} ")
        ids: List[int] = []
        for chunk in text.split():
            if chunk in self.added_tokens:
                ids.append(self.added_tokens[chunk])
                continue
            for w in re.findall(r"[\w]+|[^\s\w]", chunk):
                if self._bpe:
                    unk = self.encoder.get("<|endoftext|>", 0)
                    ids += [self.encoder.get(piece, unk)
                            for piece in self._bpe_word(w)]
                else:
                    h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                    ids.append(h % (self.vocab_size - 3) + 1)
        return ids

    def __call__(self, prompts, max_length: Optional[int] = None
                 ) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        max_length = max_length or self.model_max_length
        out = np.full((len(prompts), max_length), self.eos_token_id, np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.encode(p)[: max_length - 2] + \
                [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out
