"""Work of the SV3D_p configuration's SDS step, as functions of shapes: its
FLOPs (matrix products and convolutions forward, the backward's through
the sampled frame's encode and the texture MLP; what
`torch.utils.flop_counter` counts on the plain reference), the FLOPs of the
spatial self-attentions that the port sends to its flash kernel (K3), and
the bytes of every GroupNorm call of the step (K6: x read once, y written
once).

The video UNet is described by the reference's `VideoUNetConfig`; its call
takes B batch items of T frames. Counts of the spatial layers come from
`counts` (the SD2 UNet's), the temporal halves are added here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.work.counts import (_levels, attention_flops, conv, dense,
                                   mlp_bwd_flops, mlp_fwd_flops, resnet,
                                   transformer, vae_encoder)

# the port's routing rule: the kernel when Sq >= 256 and Skv >= 1024
MIN_SQ_KERNEL, MIN_KV_KERNEL = 256, 1024


def video_resblock(B, T, cin, cout, h, w, temb) -> float:
    """The spatial ResBlock at B T frames and its time_stack: two
    (3, 1, 1) convolutions and the frames' embedding projection."""
    return (resnet(B * T, cin, cout, h, w, temb)
            + 2 * 2.0 * B * T * h * w * cout * cout * 3
            + dense(B * T, temb, cout))


def video_transformer(B, T, c, s, heads, ctx_dim, ctx_len=1
                      ) -> Tuple[float, float]:
    """(FLOPs, K3's share) of one spatial transformer and its temporal
    block over s positions: the frame index's MLP (T rows), ff_in,
    self-attention over the T frames, cross-attention to the first
    frame's ctx_len tokens (keys and values projected at every position),
    ff."""
    d = c // heads
    lin, att = transformer(B * T, c, s, heads, ctx_dim, ctx_len)
    spatial_self = attention_flops(B * T, heads, s, s, d)
    k3 = spatial_self if s >= MIN_SQ_KERNEL and s >= MIN_KV_KERNEL else 0.0
    rows = B * s * T
    f = dense(T, c, 4 * c) + dense(T, 4 * c, c)
    f += 2 * (dense(rows, c, 8 * c) + dense(rows, 4 * c, c))  # ff_in, ff
    f += 4 * dense(rows, c, c) + attention_flops(B * s, heads, T, T, d)
    f += 2 * dense(rows, c, c) + 2 * dense(B * s * ctx_len, ctx_dim, c)
    f += attention_flops(B * s, heads, T, ctx_len, d)
    return lin + att + f, k3


def video_unet(cfg, B, T, h, w, ctx_len=1) -> Dict[str, float]:
    """FLOPs of one call at B items of T frames of (h, w) latents, and
    K3's share."""
    c0 = cfg.block_out_channels[0]
    temb = 4 * c0
    nb = len(cfg.block_out_channels)
    lv = _levels(h, w, nb)
    BT = B * T
    f = dense(1, c0, temb) + dense(1, temb, temb)
    f += dense(BT, cfg.adm_in_channels, temb) + dense(BT, temb, temb)
    f += conv(BT, cfg.in_channels, c0, h, w)
    k3 = 0.0

    def attn(bi, ch, hh, ww):
        nonlocal f, k3
        a, k = video_transformer(B, T, ch, hh * ww, cfg.num_heads[bi],
                                 cfg.cross_attention_dim, ctx_len)
        f += a
        k3 += k

    ch, res = c0, [c0]
    for bi, out in enumerate(cfg.block_out_channels):
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block):
            f += video_resblock(B, T, ch, out, hh, ww, temb)
            ch = out
            if cfg.is_cross(bi):
                attn(bi, out, hh, ww)
            res.append(out)
        if bi < nb - 1:
            f += conv(BT, out, out, *lv[bi + 1])
            res.append(out)
    hh, ww = lv[-1]
    f += 2 * video_resblock(B, T, ch, ch, hh, ww, temb)
    attn(nb - 1, ch, hh, ww)
    for bi in reversed(range(nb)):
        out = cfg.block_out_channels[bi]
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block + 1):
            f += video_resblock(B, T, ch + res.pop(), out, hh, ww, temb)
            ch = out
            if cfg.is_cross(bi):
                attn(bi, out, hh, ww)
        if bi > 0:
            f += conv(BT, out, out, *lv[bi - 1])
    f += conv(BT, c0, cfg.out_channels, h, w)
    return {"flops": f, "k3_flops": k3}


def unet_groupnorm_numels(cfg, B, T, h, w) -> List[int]:
    """Elements of every GroupNorm call's x in one UNet call, in order."""
    c0 = cfg.block_out_channels[0]
    nb = len(cfg.block_out_channels)
    lv = _levels(h, w, nb)
    BT = B * T
    out: List[int] = []

    def rb(cin, cout, hh, ww):
        out.extend([BT * cin * hh * ww] + [BT * cout * hh * ww] * 3)

    ch, res = c0, [c0]
    for bi, c in enumerate(cfg.block_out_channels):
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block):
            rb(ch, c, hh, ww)
            ch = c
            if cfg.is_cross(bi):
                out.append(BT * c * hh * ww)
            res.append(c)
        if bi < nb - 1:
            res.append(c)
    hh, ww = lv[-1]
    rb(ch, ch, hh, ww)
    out.append(BT * ch * hh * ww)
    rb(ch, ch, hh, ww)
    for bi in reversed(range(nb)):
        c = cfg.block_out_channels[bi]
        hh, ww = lv[bi]
        for _ in range(cfg.layers_per_block + 1):
            rb(ch + res.pop(), c, hh, ww)
            ch = c
            if cfg.is_cross(bi):
                out.append(BT * c * hh * ww)
    out.append(BT * c0 * h * w)
    return out


def vae_groupnorm_numels(vcfg, B, h, w) -> List[int]:
    """Elements of every GroupNorm call's x in one VAE encode."""
    chans = vcfg.block_out_channels
    out: List[int] = []
    ch = chans[0]
    for bi, c in enumerate(chans):
        for _ in range(vcfg.layers_per_block):
            out += [B * ch * h * w, B * c * h * w]
            ch = c
        if bi < len(chans) - 1:
            h, w = h // 2, w // 2
    out += [B * ch * h * w] * 5 + [B * ch * h * w]  # mid: 2 resnets, attn
    return out


def sds_step(cfg, vcfg, frames: int, frame_px: int, itemsize: int = 2
             ) -> dict:
    """FLOPs of one SDS step over the orbit by part; K3's FLOPs and K6's
    bytes a step."""
    down = vcfg.downsample
    lat = frame_px // down
    u = video_unet(cfg, 2, frames, lat, lat)
    P2 = frame_px * frame_px
    parts = {"teacher": u["flops"],
             "vae": (vae_encoder(vcfg, frames, frame_px, frame_px)
                     + vae_encoder(vcfg, 1, frame_px, frame_px)
                     + vae_encoder(vcfg, 1, frame_px, frame_px,
                                   backward=True)),
             "mlp": (mlp_fwd_flops(frames * P2) + mlp_fwd_flops(P2)
                     + mlp_bwd_flops(P2))}
    gn = (unet_groupnorm_numels(cfg, 2, frames, lat, lat)
          + vae_groupnorm_numels(vcfg, frames, frame_px, frame_px)
          + vae_groupnorm_numels(vcfg, 1, frame_px, frame_px))
    return {"flops": sum(parts.values()), "parts": parts,
            "k3_flops": u["k3_flops"],
            "k6_bytes": float(sum(gn) * 2 * itemsize),
            "groupnorm_calls": len(gn)}
