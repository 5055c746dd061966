"""Work of the FLUX.1 Depth [dev] configuration's SDS step, as functions of
shapes: its FLOPs (matrix products and convolutions forward, the
backward's through the slice's encode and the texture MLP; what
`torch.utils.flop_counter` counts on the plain reference) and the FLOPs of
the joint attentions that the port sends to its flash kernel at head dim
128 (K3).

The MMDiT is described by the reference's `Config`; a call takes one
canvas of n packed image tokens and L text tokens, every block attending
over n + L. FLUX.1's AE encoder is `counts.vae_encoder` without its
quant_conv.
"""

from __future__ import annotations

from typing import Dict

from portbench.work.counts import (attention_flops, conv, dense,
                                   mlp_bwd_flops, mlp_fwd_flops, vae_encoder)

# the port's routing rule: the kernel when Sq >= 256 and Skv >= 1024
MIN_SQ_KERNEL, MIN_KV_KERNEL = 256, 1024


def ae_encoder(vcfg, B, h, w, backward=False) -> float:
    """FLUX.1's AE encoder: SD's, less the quant_conv at the latents."""
    down = 2 ** (len(vcfg.block_out_channels) - 1)
    c2 = 2 * vcfg.latent_channels
    return vae_encoder(vcfg, B, h, w, backward) - \
        conv(B, c2, c2, h // down, w // down, 1)


def mmdit(cfg, n: int, L: int) -> Dict[str, float]:
    """FLOPs of one call over n image and L text tokens, and K3's share:
    the embeddings, the batch-1 modulations, the blocks' products and their
    joint attentions, the last layer."""
    h, m, d = cfg.hidden_size, cfg.mlp_dim, cfg.hidden_size // cfg.num_heads
    S = n + L
    f = dense(n, cfg.in_channels, h) + dense(L, cfg.context_in_dim, h)
    f += 2 * (dense(1, 256, h) + dense(1, h, h))  # time_in, guidance_in
    f += dense(1, cfg.vec_in_dim, h) + dense(1, h, h)  # vector_in
    att = attention_flops(1, cfg.num_heads, S, S, d)
    k3 = att if S >= MIN_SQ_KERNEL and S >= MIN_KV_KERNEL else 0.0
    double = 2 * dense(1, h, 6 * h) + att
    for rows in (n, L):  # each stream's qkv, proj and MLP
        double += dense(rows, h, 3 * h) + dense(rows, h, h) + \
            dense(rows, h, m) + dense(rows, m, h)
    single = dense(1, h, 3 * h) + dense(S, h, 3 * h + m) + \
        dense(S, h + m, h) + att
    f += cfg.depth * double + cfg.depth_single_blocks * single
    f += dense(1, h, 2 * h) + dense(n, h, cfg.out_channels)
    blocks = cfg.depth + cfg.depth_single_blocks
    return {"flops": f, "k3_flops": blocks * k3}


def sds_step(cfg, vcfg, tile_px: int, text_tokens: int,
             margin_px: int) -> dict:
    """FLOPs of one SDS step by part (the local_sds_grad step over the 3x2
    grid of tile_px tiles) and K3's FLOPs."""
    H, W = 3 * tile_px, 2 * tile_px
    down = 2 ** (len(vcfg.block_out_channels) - 1)
    n = (H // down // 2) * (W // down // 2)
    sl_h, sl_w = min(tile_px + 2 * margin_px, H), \
        min(tile_px + 2 * margin_px, W)
    teacher = mmdit(cfg, n, text_tokens)
    parts = {"teacher": teacher["flops"],
             "mlp": mlp_fwd_flops(H * W) + mlp_fwd_flops(sl_h * sl_w)
             + mlp_bwd_flops(sl_h * sl_w),
             "vae": ae_encoder(vcfg, 1, H, W) + ae_encoder(vcfg, 1, sl_h, sl_w)
             + ae_encoder(vcfg, 1, sl_h, sl_w, backward=True)}
    return {"flops": sum(parts.values()), "parts": parts,
            "k3_flops": teacher["k3_flops"], "image_tokens": n}
