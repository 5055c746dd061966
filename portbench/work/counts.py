"""Work of the measured paths, as functions of shapes: the FLOPs of an SDS
step and of a generated grid (matrix products and convolutions, forward
and backward, no recomputation; what `torch.utils.flop_counter` counts on
the plain reference), and the per-kernel counts behind the rooflines: the
texture MLP's operations, GroupNorm's bytes (x read once, y written once)
and attention's FLOPs (4 B H Sq (Skv + Se) d).

Towers are described by the reference's `UNetConfig` / `VAEConfig`. A
backward through a frozen tower computes input gradients only: one pass of
the forward's products for every convolution and dense layer, two for
each attention product (both operands carry gradients).
"""

from __future__ import annotations

from typing import Tuple

MLP_WIDTH, MLP_DEPTH, MLP_SKIP, MLP_IN, MLP_OUT = 256, 8, 4, 42, 3


def conv(B, cin, cout, h_out, w_out, k=3) -> float:
    return 2.0 * B * cout * h_out * w_out * cin * k * k


def dense(rows, fin, fout) -> float:
    return 2.0 * rows * fin * fout


def attention_flops(B, H, sq, skv, d) -> float:
    """Q K^T and P V: 4 B H Sq Skv d (Skv counts both KV sources)."""
    return 4.0 * B * H * sq * skv * d


def groupnorm_bytes(numel: int, in_bytes: int, out_bytes: int) -> int:
    return numel * (in_bytes + out_bytes)


# -- the texture MLP ------------------------------------------------------------------

def mlp_macs() -> int:
    """Multiply-adds of one point through the 8x256 skip MLP: 481,024."""
    fan, macs = MLP_IN, 0
    for i in range(MLP_DEPTH):
        macs += fan * MLP_WIDTH
        fan = MLP_WIDTH + (MLP_IN if i == MLP_SKIP else 0)
    return macs + fan * MLP_OUT


def mlp_fwd_flops(points: int) -> float:
    return 2.0 * points * mlp_macs()


def mlp_bwd_flops(points: int) -> float:
    """dW of every layer and dX of every layer but the first (its input,
    the embedding, carries no gradient)."""
    return 2.0 * points * (2 * mlp_macs() - MLP_IN * MLP_WIDTH)


# -- towers ----------------------------------------------------------------------------

def resnet(B, cin, cout, h, w, temb=None) -> float:
    f = conv(B, cin, cout, h, w) + conv(B, cout, cout, h, w)
    if temb is not None:
        f += dense(B, temb, cout)
    if cin != cout:
        f += conv(B, cin, cout, h, w, 1)
    return f


def transformer(B, c, s, heads, ctx_dim, ctx_len, extra=0) -> Tuple[float,
                                                                   float]:
    """(dense FLOPs, attention FLOPs) of one spatial transformer of depth 1
    over s tokens, `extra` reference tokens appended to the self-attention's
    keys and values."""
    d = c // heads
    lin = dense(B * s, c, c) * 2  # proj_in, proj_out
    lin += dense(B * s, c, c) * 4  # attn1 q, k, v, out
    lin += dense(B * extra, c, c) * 2  # the reference tokens' k, v
    lin += dense(B * s, c, c) * 2 + dense(B * ctx_len, ctx_dim, c) * 2  # attn2
    lin += dense(B * s, c, 8 * c) + dense(B * s, 4 * c, c)  # GEGLU
    att = attention_flops(B, heads, s, s + extra, d) + \
        attention_flops(B, heads, s, ctx_len, d)
    return lin, att


def _levels(h, w, n):
    out = []
    for _ in range(n):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def down_path(cfg, B, h, w, ctx_len, extra_hw=None) -> float:
    """conv_in, time embedding, down blocks and mid block of the UNet or the
    ControlNet at (B, in, h, w); extra_hw gives the reference tokens' (h, w)
    at level 0 (halved with the levels)."""
    c0 = cfg.block_out_channels[0]
    f = dense(B, c0, 4 * c0) + dense(B, 4 * c0, 4 * c0)
    f += conv(B, cfg.in_channels, c0, h, w)
    nb = len(cfg.block_out_channels)
    lv = _levels(h, w, nb)
    ev = _levels(*extra_hw, nb) if extra_hw else None
    ch = c0
    for bi, out in enumerate(cfg.block_out_channels):
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block):
            f += resnet(B, ch, out, hh, ww, 4 * c0)
            ch = out
            if cfg.is_cross(bi):
                e = ev[bi][0] * ev[bi][1] if ev else 0
                f += sum(transformer(B, out, hh * ww, cfg.num_heads[bi],
                                     cfg.cross_attention_dim, ctx_len, e))
        if bi < nb - 1:
            f += conv(B, out, out, *lv[bi + 1])
    hh, ww = lv[-1]
    mid = cfg.block_out_channels[-1]
    e = ev[-1][0] * ev[-1][1] if ev else 0
    f += 2 * resnet(B, mid, mid, hh, ww, 4 * c0)
    f += sum(transformer(B, mid, hh * ww, cfg.num_heads[-1],
                         cfg.cross_attention_dim, ctx_len, e))
    return f


def residual_channels(cfg):
    c0 = cfg.block_out_channels[0]
    res, nb = [c0], len(cfg.block_out_channels)
    for bi, out in enumerate(cfg.block_out_channels):
        res += [out] * cfg.layers_per_block
        if bi < nb - 1:
            res.append(out)
    return res


def unet(cfg, B, h, w, ctx_len, extra_hw=None) -> float:
    f = down_path(cfg, B, h, w, ctx_len, extra_hw)
    c0 = cfg.block_out_channels[0]
    nb = len(cfg.block_out_channels)
    lv = _levels(h, w, nb)
    ev = _levels(*extra_hw, nb) if extra_hw else None
    res = residual_channels(cfg)
    ch = cfg.block_out_channels[-1]
    for bi in reversed(range(nb)):
        out = cfg.block_out_channels[bi]
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block + 1):
            skip = res.pop()
            f += resnet(B, ch + skip, out, hh, ww, 4 * c0)
            ch = out
            if cfg.is_cross(bi):
                e = ev[bi][0] * ev[bi][1] if ev else 0
                f += sum(transformer(B, out, hh * ww, cfg.num_heads[bi],
                                     cfg.cross_attention_dim, ctx_len, e))
        if bi > 0:
            f += conv(B, out, out, *lv[bi - 1])
    return f + conv(B, c0, cfg.out_channels, h, w)


def controlnet(cfg, B, h, w, ctx_len) -> float:
    f = down_path(cfg, B, h, w, ctx_len)
    nb = len(cfg.block_out_channels)
    lv = _levels(h, w, nb)
    level = [0]
    for bi in range(nb):
        level += [bi] * cfg.layers_per_block
        if bi < nb - 1:
            level.append(bi + 1)
    for c, li in zip(residual_channels(cfg), level):
        f += conv(B, c, c, *lv[li], 1)
    mid = cfg.block_out_channels[-1]
    return f + conv(B, mid, mid, *lv[-1], 1)


def hint_embedding(h, w, channels=(16, 32, 96, 256), c0=320) -> float:
    f = conv(1, 3, channels[0], h, w)
    for i in range(len(channels) - 1):
        f += conv(1, channels[i], channels[i], h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
        f += conv(1, channels[i], channels[i + 1], h, w)
    return f + conv(1, channels[-1], c0, h, w)


def _vae_attention(B, c, s) -> Tuple[float, float]:
    return dense(B * s, c, c) * 4, attention_flops(B, 1, s, s, c)


def vae_encoder(vcfg, B, h, w, backward=False) -> float:
    """Forward FLOPs, or with `backward` those of the input-gradient pass
    (products once, attention twice)."""
    chans = vcfg.block_out_channels
    lin = conv(B, vcfg.in_channels, chans[0], h, w)
    ch = chans[0]
    for bi, out in enumerate(chans):
        for _ in range(vcfg.layers_per_block):
            lin += resnet(B, ch, out, h, w)
            ch = out
        if bi < len(chans) - 1:
            h, w = h // 2, w // 2
            lin += conv(B, out, out, h, w)
    a_lin, att = _vae_attention(B, ch, h * w)
    lin += 2 * resnet(B, ch, ch, h, w) + a_lin
    lin += conv(B, ch, 2 * vcfg.latent_channels, h, w)
    lin += conv(B, 2 * vcfg.latent_channels, 2 * vcfg.latent_channels,
                h, w, 1)
    return lin + (2 * att if backward else att)


def vae_decoder(vcfg, B, h, w) -> float:
    chans = vcfg.block_out_channels
    lat = vcfg.latent_channels
    ch = chans[-1]
    f = conv(B, lat, lat, h, w, 1) + conv(B, lat, ch, h, w)
    a_lin, att = _vae_attention(B, ch, h * w)
    f += 2 * resnet(B, ch, ch, h, w) + a_lin + att
    for bi in reversed(range(len(chans))):
        out = chans[bi]
        for _ in range(vcfg.layers_per_block + 1):
            f += resnet(B, ch, out, h, w)
            ch = out
        if bi > 0:
            h, w = 2 * h, 2 * w
            f += conv(B, out, out, h, w)
    return f + conv(B, ch, vcfg.in_channels, h, w)


# -- whole units of work -----------------------------------------------------------------

def teacher_call(ucfg, lat_hw, cond_hw, ctx_len=77, branches=2) -> float:
    """One CFG teacher call: the write pass over the condition latents, the
    ControlNet and the read pass, each at batch `branches`."""
    return (unet(ucfg, branches, *cond_hw, ctx_len)
            + controlnet(ucfg, branches, *lat_hw, ctx_len)
            + unet(ucfg, branches, *lat_hw, ctx_len, extra_hw=cond_hw))


def sds_step(ucfg, vcfg, tile_px: int, cond_px: int, exact: bool,
             local_grad: bool, margin_px: int, texture_res: int) -> dict:
    """FLOPs of one SDS step by part, and the MLP's points."""
    H, W = 3 * tile_px, 2 * tile_px
    down = vcfg.downsample
    lat = (H // down, W // down)
    cond = (cond_px // down, cond_px // down)
    parts = {"teacher": teacher_call(ucfg, lat, cond)}
    if exact:
        n = texture_res * texture_res
        parts["mlp"] = mlp_fwd_flops(n) + mlp_bwd_flops(n)
        parts["vae"] = vae_encoder(vcfg, 1, H, W) + \
            vae_encoder(vcfg, 1, H, W, backward=True)
        points = {"fwd": n, "bwd": n}
    elif local_grad:
        sl_h, sl_w = min(tile_px + 2 * margin_px, H), \
            min(tile_px + 2 * margin_px, W)
        parts["mlp"] = mlp_fwd_flops(H * W) + mlp_fwd_flops(sl_h * sl_w) + \
            mlp_bwd_flops(sl_h * sl_w)
        parts["vae"] = vae_encoder(vcfg, 1, H, W) + \
            vae_encoder(vcfg, 1, sl_h, sl_w) + \
            vae_encoder(vcfg, 1, sl_h, sl_w, backward=True)
        points = {"fwd": H * W + sl_h * sl_w, "bwd": sl_h * sl_w}
    else:
        parts["mlp"] = mlp_fwd_flops(H * W) + mlp_bwd_flops(H * W)
        parts["vae"] = vae_encoder(vcfg, 1, H, W) + \
            vae_encoder(vcfg, 1, H, W, backward=True)
        points = {"fwd": H * W, "bwd": H * W}
    return {"flops": sum(parts.values()), "parts": parts, "points": points}


def clip_layers(S, hidden, heads, intermediate, layers) -> float:
    """A CLIP tower's transformer layers over S tokens (full S x S
    attention products, the text tower's causal mask included)."""
    per = dense(S, hidden, hidden) * 4 + \
        attention_flops(1, heads, S, S, hidden // heads) + \
        dense(S, hidden, intermediate) + dense(S, intermediate, hidden)
    return per * layers


def clip_text(tcfg) -> float:
    return clip_layers(tcfg.max_positions, tcfg.hidden_size, tcfg.num_heads,
                       tcfg.intermediate_size, tcfg.num_layers)


def clip_vision(vcfg_clip) -> float:
    c = vcfg_clip
    g = c.image_size // c.patch_size
    return (conv(1, 3, c.hidden_size, g, g, c.patch_size)
            + clip_layers(g * g + 1, c.hidden_size, c.num_heads,
                          c.intermediate_size, c.num_layers)
            + dense(1, c.hidden_size, c.projection_dim))


def grid(ucfg, vcfg, text_cfg, vision_cfg, height: int, width: int,
         cond_px: int, steps: int) -> dict:
    """FLOPs of one generated grid by part: the conditioning (two VAE
    encodes of the condition image, the CLIP towers, the ControlNet's hint
    embedding of the depth image resized to 8x the latent grid), `steps`
    CFG teacher calls and the VAE decode."""
    down = vcfg.downsample
    lat = (height // down, width // down)
    cond = (cond_px // down, cond_px // down)
    parts = {
        "conditioning": (2 * vae_encoder(vcfg, 1, cond_px, cond_px)
                         + clip_text(text_cfg) + clip_vision(vision_cfg)
                         + hint_embedding(8 * lat[0], 8 * lat[1],
                                          c0=ucfg.block_out_channels[0])),
        "teacher": steps * teacher_call(ucfg, lat, cond),
        "decode": vae_decoder(vcfg, 1, *lat)}
    return {"flops": sum(parts.values()), "parts": parts}
