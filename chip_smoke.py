#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (contexture_nerf_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--profile] [--sweep]
                          [--mlp-only | --raster-only [--against DIR]]

It builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version at the shapes the main path gives it (and checks that
two MLP-backward, flash-attention, rasterizer and GroupNorm runs are
bit-identical, and that planted faults miss the tolerances), then drives
the main path at full
width from a mesh on disk: `build_sds_trainer` on shapes/torus.obj at the
default config with guide.text "a photo of a dairy cow" (7 views of
1200x1200 rasterized, the 1024^2 texture, the SD2-depth front-view
bootstrap: the SD2 text tower, 51 PLMS steps of the SD2-depth UNet under
CFG at 7.5 and the 512^2 VAE decode; then the CLIP text and vision towers
and the VAE conditioning of `prepare_sds`, then the Zero123++ UNet + depth
ControlNet + SD VAE encoder + 8x256 MLP on a 960x640 canvas, bf16, random
towers from the seed) for one warm-up and three timed SDS steps, then one
step with the GroupNorms and the attention layers hooked (K6's calls, bytes
and per-shape times; K3/K4 held to their limit on every kernel-routed call,
as on one bootstrap UNet call) and one with the plain GroupNorm path.
prepare_sds's launches and each step's must equal the counts derived for
them. Any failed phase exits non-zero. The last line is {"ok": true,
"device": {...}}; the line before it is the JSON record of the kernels.
--profile also writes a torch.profiler table of one step to chiprun_out/;
--sweep also times K3/K4 at each query tile the kernel is built for.
--mlp-only runs only the K1/K2 phases, --raster-only only the K5 phase (no
main path, no result line); --against DIR then also times the K5 of the
checkout at DIR (an earlier commit unpacked there) and of this one, in
turns, each in a subprocess on the same card.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_S = 3.35e12  # HBM3, H100 SXM data sheet


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    return 1


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
        "nvidia-smi: " + r.stderr.strip()


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() over reps, each timed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms_by_kernel(fn, reps=20, tries=3):
    """{kernel name: milliseconds of device time a call of fn() spends in
    it}: the profiler's self device time over reps calls, after a warm-up.
    The profiler now and then hands back no device events for a window of
    short calls; such a window is taken again, up to `tries` times, and a
    reading that stays empty is {} ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / reps / 1e3
                 for e in p.key_averages() if e.self_device_time_total > 0}
        if times:
            return times
    return {}


def device_ms(fn, reps=20, tries=3):
    """Milliseconds of device time a call of fn() spends in kernels: the
    card's own time, without the host work between launches that cuda_ms
    also counts where a call is shorter than its host work. NaN ("not
    measured"), never 0, when the profiler saw no device events."""
    times = device_ms_by_kernel(fn, reps, tries)
    return sum(times.values()) if times else float("nan")


def bound(flops, nbytes, peak=H100_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Record:
    """Per-kernel numbers summed over the launches of one run of the main
    path's stage that launches it (one SDS step, or prepare_sds); `peak` is
    the card's operation rate for the kernel's arithmetic."""

    def __init__(self, name, source, replaces, peak=H100_BF16_FLOPS):
        self.peak = peak
        self.d = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                  "ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0,
                  "library_ms": None}

    def add(self, err, ms, plain_ms, flops, nbytes, times=1, lib_ms=None):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["ms"] += times * ms
        d["plain_ms"] += times * plain_ms
        d["flops"] += times * flops
        d["bytes"] += times * nbytes
        if lib_ms is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + times * lib_ms

    def out(self):
        d = dict(self.d)
        d["bound_ms"], d["bound_by"] = bound(d.pop("flops"), d.pop("bytes"),
                                             self.peak)
        return d


def mlp_tol(ref, ref32):
    """(tolerance, noise) for an MLP kernel output held against its plain
    bf16 version `ref`; `ref32` is the plain f32 version (see check)."""
    noise = float((ref - ref32).abs().max())
    return max(2.0 * noise, 1e-3 * float(ref.abs().max())), noise


def planted_mlp(torch, ws, bs, emb, g, fault):
    """The plain bf16 MLP with one planted fault, a stand-in for a wrong
    kernel: (output (N, 3), padded dws, dbs) through autograd, g the output
    gradient (None: forward only). "relu6_fwd" drops layer 6's ReLU;
    "relu6_mask" keeps its value but passes its gradient unmasked (a wrong
    ReLU mask in the backward); "skip_offset" takes h4's share of the
    skip-split delta from layer 5's weight rows 0:256 (the embedding's
    offset) instead of EMB_PAD:EMB_PAD+256; "dropped_chunk" leaves the
    middle point chunk of K2's dW plan out of dW_0..dW_7 (one chunk's
    partial missing from the reduce)."""
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

    if fault == "dropped_chunk":
        out, dws, dbs = planted_mlp(torch, ws, bs, emb, g, None)
        sms = (torch.cuda.get_device_properties(emb.device)
               .multi_processor_count if emb.is_cuda else 132)
        plan = mk.dw_plan(emb.shape[0], sms)
        span = plan["steps"] * mk.KSTEP
        q = slice(plan["chunks"] // 2 * span, (plan["chunks"] // 2 + 1) * span)
        _, cws, _ = planted_mlp(torch, ws, bs, emb[q], g[q], None)
        return out, [w - c if i < mk.DEPTH else w
                     for i, (w, c) in enumerate(zip(dws, cws))], dbs

    bf = torch.bfloat16

    def dot(a, b):
        return a.to(bf).float() @ b.to(bf).float()

    ws = [w.detach().clone().requires_grad_() for w in ws]
    bs = [b.detach().clone().requires_grad_() for b in bs]
    e = emb.float()
    h = e
    for i in range(mk.DEPTH):
        if i == mk.SKIP + 1 and fault == "skip_offset":
            h4 = h[:, mk.EMB_PAD:]
            wrong = dot(h4, ws[i][:mk.W].detach())
            x = dot(torch.cat([e, h4.detach()], -1), ws[i]) + bs[i] \
                + (wrong - wrong.detach())
        else:
            x = dot(h, ws[i]) + bs[i]
        if i == 6 and fault == "relu6_fwd":
            h = x
        elif i == 6 and fault == "relu6_mask":
            h = x + (torch.relu(x) - x).detach()
        else:
            h = torch.relu(x)
        if i == mk.SKIP:
            h = torch.cat([e, h], dim=-1)
    out = (dot(h, ws[mk.DEPTH]) + bs[mk.DEPTH])[:, :3]
    if g is None:
        return out.detach(), None, None
    out.backward(g)
    return out.detach(), [w.grad for w in ws], [b.grad for b in bs]


BF16_U = 2.0 ** -8  # bf16 unit roundoff: 8-bit significand, round to nearest


def attention_limit(torch, q, k, v, ek, ev, plain, rows=2048):
    """Per-element limit for flash attention held against its plain output
    `plain` (f32, shaped like it). The two round P to bf16 at different
    points: the kernel before normalisation (exp(s - m) with its running m),
    the plain version after (p / l); each rounding errs by at most u = 2^-8
    of P, so element (i, c) of the sums differs by d = sum_j e_j P_ij v_jc,
    |e_j| <= 2u. That is at most R = 2u sum_j P_ij |v_jc|. Keys that are
    copies of one another (a flat background gives many) share their P, v
    and rounding, so each group g of identical (k_j, v_j) rows adds one
    term e_g W_ig v_gc, W_ig = sum over g of P_ij; distinct groups' e_g act
    as independent uniform draws, and d stays within 8 standard deviations,
    8 u sqrt(2/3 sum_g W_ig^2 v_gc^2). d is the smaller of the two; then both
    round the output to bf16, which adds one bf16 ulp at |plain| + d. The
    f32 sums' own rounding is ~2^-24 of these and is left out. P is the
    plain version's f32 softmax, taken `rows` queries at a time."""
    if ek is not None:
        k, v = torch.cat([k, ek], 2), torch.cat([v, ev], 2)
    kf, vf = k.float(), v.float()
    va = vf.abs()
    B, H = q.shape[:2]
    groups = {}  # (b, h) -> (group of each key, v of each group squared)
    for b in range(B):
        for h in range(H):
            rows_kv = torch.cat([k[b, h], v[b, h]], -1).view(torch.int16)
            _, inv = torch.unique(rows_kv, dim=0, return_inverse=True)
            vg = vf.new_zeros((int(inv.max()) + 1, vf.shape[-1]))
            groups[b, h] = inv, vg.index_copy_(0, inv, vf[b, h]) ** 2
    parts = []
    for i in range(0, q.shape[2], rows):
        logits = torch.matmul(q[:, :, i:i + rows].float(),
                              kf.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        p = torch.softmax(logits, dim=-1)
        del logits
        r = 2.0 * BF16_U * torch.matmul(p, va)
        var = torch.empty_like(r)
        for (b, h), (inv, vg2) in groups.items():
            w = p.new_zeros((p.shape[2], vg2.shape[0]))
            w.index_add_(1, inv, p[b, h])
            var[b, h] = torch.matmul(w * w, vg2)
        del p
        sd = BF16_U * torch.sqrt(2.0 / 3.0 * var)
        parts.append(torch.minimum(r, 8.0 * sd))
    d = torch.cat(parts, 2)
    mag = (plain.float().abs() + d).clamp(min=2.0 ** -126)
    return d + torch.exp2(torch.floor(torch.log2(mag)) - 7.0)


def attention_ratio(torch, got, plain, limit):
    """max |got - plain| / limit over the elements (<= 1 passes)."""
    return float(((got.float() - plain.float()).abs() / limit).max())


ATTENTION_FAULTS = {"scale": "softmax scale 1/sqrt(128) for 1/sqrt(64)",
                    "dropped": "second KV source dropped",
                    "tail": "ragged tails unmasked (zero keys up to the tile)"}


def planted_attention(torch, fn, q, k, v, ek, ev, fault, tile):
    """Attention with one planted fault, a stand-in for a wrong kernel:
    "scale" and "dropped" run `fn` (the kernel, or the plain version) with
    q scaled by sqrt(1/2) (the TPU's padded width in the scale) or without
    the second source; "tail" runs the plain version on each source padded
    with zero keys and values up to a multiple of `tile` keys, which is what
    a kernel that forgot its tail mask computes (TMA reads zeros past the
    end, and a zero key scores 0). None when the fault does not apply."""
    from contexture_nerf_tpu_torch.ops.attention import flash_attention_plain

    if fault == "scale":
        return fn((q.float() * 0.5 ** 0.5).to(q.dtype), k, v, ek, ev)
    if fault == "dropped":
        return fn(q, k, v) if ek is not None else None

    def pad(t):
        if t is None or not t.shape[2] % tile:
            return t
        n = -t.shape[2] % tile
        return torch.cat([t, t.new_zeros(t.shape[:2] + (n, t.shape[3]))], 2)

    if all(t is None or not t.shape[2] % tile for t in (k, ek)):
        return None
    return flash_attention_plain(q, pad(k), pad(v), pad(ek), pad(ev))


def mlp_bwd_breakdown(torch, mk, wflat, bflat, wt, emb, g, n):
    """K2's device time by kernel (TFLOP/s where its operations are
    counted), the bytes of its buffers and the card's peak memory in a
    call."""
    sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
    plan = mk.dw_plan(n, sms)
    hidden = 2.0 * n * mk.W * sum(mk.LAYER_K[:mk.DEPTH])
    flops = {"mlp_fwd_kernel<1>": ("the recompute", hidden),
             "mlp_fwd_kernel<2>": ("the delta loop",
                                   2.0 * n * mk.W * mk.DELTA_ROWS),
             "mlp_bwd_dw_kernel": ("dW_0..dW_7", hidden)}
    for name, t in sorted(device_ms_by_kernel(
            lambda: mk.mlp_bwd_kernel(wflat, bflat, emb, g, None, wt)
            ).items(), key=lambda kv: -kv[1]):
        rate = "".join(f" ({f / t / 1e9:.0f} TFLOP/s, {what})"
                       for k, (what, f) in flops.items() if k in name)
        print(f"      {name[:70]}: device {t:.3f} ms{rate}")
    buffers = 2 * n * mk.ACTS_LD * 2
    partials = 4 * (plan["chunks"] * mk.HIDDEN_NUMEL
                    + -(-n // mk.OUT_CHUNK) * mk.W * mk.OUT_PAD
                    + 2 * sms * mk.B_NUMEL)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mk.mlp_bwd_kernel(wflat, bflat, emb, g, None, wt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"      buffers: act + delta {buffers / 1e9:.3f} GB, partials "
          f"{partials / 1e6:.1f} MB ({plan['chunks']} chunks of "
          f"{plan['steps']} k-steps); peak {peak / 2 ** 30:.2f} GiB "
          f"({(peak - base) / 2 ** 30:.2f} GiB above the inputs)")


def mlp_phases(torch, rec_fwd, rec_bwd, seed, n_canvas, n_slice, failures):
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    mlp = NeRF2D(generator=gen, device=dev).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    bf = torch.bfloat16
    wflat, bflat = mk.flatten_params(ws, bs, bf)
    wt = mk.transposed_stack(wflat)  # K2's delta weights, packed once
    macs = sum(l.in_features * l.out_features for l in mlp.linears())
    wbytes = wflat.numel() * 2 + bflat.numel() * 4
    f32 = torch.float32

    def check(name, got, ref, ref32):
        """Kernel vs plain bf16 against the bf16 noise level: both round
        every matmul operand to bf16 at the same points and sum in f32 in
        other orders, so a sum next to a rounding boundary flips one ulp and
        the flip cascades through the later layers. The plain bf16 version's
        distance from plain f32 measures that noise; the kernel must stay
        within twice it (or 1e-3 of max|plain| where bf16 is exact). The
        planted faults below show that a wrong kernel misses it."""
        err = float((got - ref).abs().max())
        tol, noise = mlp_tol(ref, ref32)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = max(2 x "
              f"bf16-vs-f32 {noise:.3e}, 1e-3 max|plain|); max|plain| "
              f"{float(ref.abs().max()):.3e}) {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(name)
        return err

    def caught(name, got, refs, refs32):
        """A planted fault must miss the tolerance on at least one tensor."""
        ratio = max(float((a - b).abs().max()) / mlp_tol(b, c)[0]
                    for a, b, c in zip(got, refs, refs32))
        print(f"  planted fault {name}: max err/tol {ratio:.2f} "
              f"{'caught' if ratio > 1 else 'NOT CAUGHT'}")
        if not ratio > 1:
            failures.append(f"tolerance passes planted fault {name}")

    def fwd_identical(name, x, multires):
        same = torch.equal(mk.mlp_fwd_kernel(wflat, bflat, x, multires),
                           mk.mlp_fwd_kernel(wflat, bflat, x, multires))
        print(f"  {name}: two runs bit-identical {same}")
        if not same:
            failures.append(f"{name} determinism")

    k1_device = [0.0]  # K1's device ms summed over a step's launches
    for label, n in (("canvas", n_canvas), ("slice", n_slice),
                     ("ragged", 1000)):  # ragged: off the 256-point tile
        uv = torch.rand((n, 2), generator=gen, device=dev)
        emb = mk.pad_embedding(uv, 10, dtype=bf)
        err = check(f"K1 mlp_fwd emb {label} ({n}, 48)",
                    mk.mlp_fwd_kernel(wflat, bflat, emb, None),
                    mk.fused_nerf2d_plain(ws, bs, emb, None, bf),
                    mk.fused_nerf2d_plain(ws, bs, emb, None, f32))
        if label == "slice":
            check(f"K1 mlp_fwd uv {label} ({n}, 2)",
                  mk.mlp_fwd_kernel(wflat, bflat, uv, 10),
                  mk.fused_nerf2d_plain(ws, bs, uv, 10, bf),
                  mk.fused_nerf2d_plain(ws, bs, uv, 10, f32))
        if label == "ragged":
            continue
        if label == "slice":
            caught("K1 relu6_fwd (layer 6 without its ReLU)",
                   [planted_mlp(torch, ws, bs, emb, None, "relu6_fwd")[0]],
                   [mk.fused_nerf2d_plain(ws, bs, emb, None, bf)],
                   [mk.fused_nerf2d_plain(ws, bs, emb, None, f32)])
        fwd_identical(f"K1 {label}", emb, None)
        ms = cuda_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, emb, None))
        dms = device_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, emb, None),
                        reps=10)
        pms = cuda_ms(lambda: mk.fused_nerf2d_plain(ws, bs, emb, None, bf),
                      reps=5)
        flops = 2.0 * n * macs
        b_ms = bound(flops, n * 48 * 2 + n * 3 * 4 + wbytes)[0]
        print(f"    ms {ms:.3f} (device time {dms:.3f}, "
              f"{flops / dms / 1e9:.0f} TFLOP/s) plain_ms {pms:.3f} "
              f"bound_ms {b_ms:.3f}")
        k1_device[0] += dms
        rec_fwd.add(err, ms, pms, flops, n * 48 * 2 + n * 3 * 4 + wbytes)

    # K2 on the slice, then on a ragged count
    for label, n in (("slice", n_slice), ("ragged", 1000)):
        uv = torch.rand((n, 2), generator=gen, device=dev)
        emb = mk.pad_embedding(uv, 10, dtype=bf)
        g = torch.randn((n, 3), generator=gen, device=dev) * 1e-2
        dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None, wt)
        rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf)
        fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, f32)
        err = 0.0
        for i, (a, b, c) in enumerate(zip(dws + dbs, rws + rbs, fws + fbs)):
            err = max(err, check(f"K2 mlp_bwd {label} "
                                 f"{'dW' if i < 9 else 'db'}{i % 9} "
                                 f"{tuple(b.shape)}", a, b, c))
        if label == "ragged":
            continue
        dws2, dbs2 = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None, wt)
        same = all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))
        print(f"  K2 two runs bit-identical: {same}")
        if not same:
            failures.append("K2 determinism")
        check("K2 mlp_bwd uv dW0",
              mk.mlp_bwd_kernel(wflat, bflat, uv, g, 10, wt)[0][0], rws[0],
              fws[0])
        for fault in ("relu6_mask", "skip_offset", "dropped_chunk"):
            _, pws, pbs = planted_mlp(torch, ws, bs, emb, g, fault)
            caught(f"K2 {fault}", pws + pbs, rws + rbs, fws + fbs)
        def k2():
            return mk.mlp_bwd_kernel(wflat, bflat, emb, g, None, wt)

        ms = cuda_ms(k2)
        flops = 2.0 * n * (3 * macs - 42 * 256)
        dms = device_ms(k2, reps=10)
        pms = cuda_ms(
            lambda: mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf),
            reps=5)
        nbytes = (n * 48 * 2 + n * 3 * 4 + wbytes
                  + (wflat.numel() + bflat.numel()) * 4)
        print(f"    ms {ms:.3f} (device time {dms:.3f}, "
              f"{flops / dms / 1e9:.0f} TFLOP/s) plain_ms {pms:.3f} "
              f"bound_ms {bound(flops, nbytes)[0]:.3f}")
        mlp_bwd_breakdown(torch, mk, wflat, bflat, wt, emb, g, n)
        rec_bwd.add(err, ms, pms, flops, nbytes)

    # K1 on the texture lattice that prepare_sds queries twice (the 7 views,
    # the bootstrap's front pose; uv in); its time is printed here and kept
    # out of the per-step record
    from contexture_nerf_tpu_torch.models.fields import uv_lattice

    uv = uv_lattice(1024, device=dev)
    err = check(f"K1 mlp_fwd uv lattice ({uv.shape[0]}, 2)",
                mk.mlp_fwd_kernel(wflat, bflat, uv, 10),
                mk.fused_nerf2d_plain(ws, bs, uv, 10, bf),
                mk.fused_nerf2d_plain(ws, bs, uv, 10, f32))
    rec_fwd.d["max_abs_err"] = max(rec_fwd.d["max_abs_err"], err)
    fwd_identical("K1 lattice", uv, 10)
    ms = cuda_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, uv, 10))
    dms = device_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, uv, 10), reps=10)
    pms = cuda_ms(lambda: mk.fused_nerf2d_plain(ws, bs, uv, 10, bf), reps=3)
    flops = 2.0 * uv.shape[0] * macs
    b_ms, b_by = bound(flops, uv.shape[0] * (2 * 4 + 3 * 4) + wbytes)
    print(f"    ms {ms:.3f} (device time {dms:.3f}, {flops / dms / 1e9:.0f} "
          f"TFLOP/s) plain_ms {pms:.3f} bound_ms {b_ms:.3f} ({b_by}); twice "
          "per prepare_sds")
    print(f"  K1 at the step's shapes (canvas + slice): device time "
          f"{k1_device[0]:.3f} ms")


# (B, H, Sq, Skv, Se, launches a step, launches in prepare_sds) of the
# attention phase: the main path's routed shapes (the SDS step's teacher:
# UNet write and read passes and ControlNet at 9600, 2400 and 1600 tokens,
# the read pass's second source of 1600 and 400 reference tokens; the
# bootstrap's SD2-depth UNet: 5 self-attentions at 64^2 and 5 at 32^2
# tokens in each of its 51 PLMS calls), then ragged ones
ATTENTION_SHAPES = [
    (2, 5, 1600, 1600, 0, 5, 0), (2, 5, 9600, 9600, 0, 2, 0),
    (2, 10, 2400, 2400, 0, 2, 0), (2, 5, 9600, 9600, 1600, 5, 0),
    (2, 10, 2400, 2400, 400, 5, 0), (2, 5, 4096, 4096, 0, 0, 5 * 51),
    (2, 10, 1024, 1024, 0, 0, 5 * 51), (1, 3, 777, 1234, 0, 0, 0),
    (1, 3, 777, 1234, 301, 0, 0)]


def attention_check(torch, att, args, failures, name, faults=True):
    """The kernel on args (q, k, v, extra_k, extra_v) against the plain
    version within attention_limit, two runs bit-identical, and (faults)
    the planted faults outside the limit. Returns max |kernel - plain|."""
    got = att.flash_attention(*args)
    same = torch.equal(got, att.flash_attention(*args))
    plain = att.flash_attention_plain(*args)
    limit = attention_limit(torch, *args, plain)
    ratio = attention_ratio(torch, got, plain, limit)
    err = float((got.float() - plain.float()).abs().max())
    ok = ratio <= 1.0 and same and bool(torch.isfinite(got.float()).all())
    print(f"  {name}: max_abs_err {err:.3e}, max err/limit {ratio:.3f}, two "
          f"runs bit-identical {same} {'ok' if ok else 'MISS'}")
    if not ok:
        failures.append(name)
    if not faults:
        return err
    keys = args[1].shape[2] + (0 if args[3] is None else args[3].shape[2])
    pad = sum(-t.shape[2] % att.KV_TILE for t in args[1::2] if t is not None)
    for fault, what in ATTENTION_FAULTS.items():
        bad = planted_attention(torch, att.flash_attention, *args, fault,
                                att.KV_TILE)
        if bad is None:
            continue
        r = attention_ratio(torch, bad, plain, limit)
        # a forgotten tail mask must show where its zero keys are >= 2% of
        # all keys (the 1600-key tail, the 2400 + 400 tails)
        need = fault != "tail" or pad >= 0.02 * keys
        verdict = "caught" if r > 1 else ("NOT CAUGHT" if need else
                                          "not caught (not required)")
        print(f"    planted fault {what}: max err/limit {r:.2f} {verdict}"
              + (f" ({pad} zero keys among {keys})" if fault == "tail"
                 else ""))
        if need and not r > 1:
            failures.append(f"{name}: limit passes planted fault {fault}")
    return err


def attention_phases(torch, rec1, rec2, seed, sweep, failures):
    """K3/K4 at ATTENTION_SHAPES on (B, H, S, 64) views of (B, S, H, 64)
    memory, the layout the attention layers pass: held to attention_limit,
    bit-identical twice, planted faults caught; timed against the plain
    version and SDPA. The step's shapes go into the per-step records;
    prepare_sds's are summed over its launches and printed apart."""
    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prep = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
            "library_device_ms": 0.0, "flops": 0.0, "bytes": 0.0,
            "launches": 0}
    step = {3: [0.0, 0.0], 4: [0.0, 0.0]}  # K3, K4: device ms, SDPA's
    for B, H, sq, skv, se, times, prep_times in ATTENTION_SHAPES:
        def heads(s):
            return torch.randn((B, s, H, 64), generator=gen, device=dev,
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
        args = (heads(sq), heads(skv), heads(skv)) + (
            (heads(se), heads(se)) if se else (None, None))
        name = f"K{4 if se else 3} flash ({B},{H},{sq},{skv}+{se})"
        err = attention_check(torch, att, args, failures, name)
        q, k, v, ek, ev = args
        ms = cuda_ms(lambda: att.flash_attention(*args))
        pms = cuda_ms(lambda: att.flash_attention_plain(*args), reps=3,
                      warmup=1)
        kc = torch.cat([k, ek], 2) if se else k
        vc = torch.cat([v, ev], 2) if se else v
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kc, vc))
        nkv = skv + se
        flops = 4.0 * B * H * sq * nkv * 64
        nbytes = 2 * B * H * 64 * (2 * sq + 2 * nkv)
        b_ms = bound(flops, nbytes)[0]
        dms = device_ms(lambda: att.flash_attention(*args))
        dlms = device_ms(lambda: F.scaled_dot_product_attention(q, kc, vc))
        print(f"    ms {ms:.4f} plain_ms {pms:.3f} library_ms {lms:.4f} "
              f"(SDPA) bound_ms {b_ms:.4f}; device time {dms:.4f} ms, "
              f"{flops / dms / 1e9:.0f} TFLOP/s (SDPA {dlms:.4f} ms, "
              f"{flops / dlms / 1e9:.0f})")
        if sweep and (times or prep_times):
            row = []
            for bm in att.BLOCK_M:
                t = device_ms(lambda: att.flash_attention(*args, bm))
                row.append(f"{bm} {t:.4f}")
            print(f"    query-tile sweep ({att.KV_TILE} keys a tile; query "
                  f"rows: device ms): " + ", ".join(row))
        rec = rec2 if se else rec1
        rec.add(err, ms, pms, flops, nbytes, times, lms if times else None)
        step[4 if se else 3][0] += times * dms
        step[4 if se else 3][1] += times * dlms
        if prep_times:
            for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                             ("device_ms", dms), ("library_device_ms", dlms),
                             ("flops", flops), ("bytes", nbytes)):
                prep[key] += prep_times * val
            prep["launches"] += prep_times
    # the other side of the routing rule: the step's self-attentions that it
    # sends to the plain path, through the kernel beside it (a reading for
    # the thresholds; nothing here changes the rule)
    for B, H, sq, skv, se in ((2, 20, 600, 600, 100), (2, 5, 256, 256, 0)):
        def heads(s):
            return torch.randn((B, s, H, 64), generator=gen, device=dev,
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
        args = (heads(sq), heads(skv), heads(skv)) + (
            (heads(se), heads(se)) if se else (None, None))
        attention_check(torch, att, args, failures,
                        f"unrouted ({B},{H},{sq},{skv}+{se}) through the "
                        f"kernel", faults=False)
        ms = cuda_ms(lambda: att.flash_attention(*args))
        pms = cuda_ms(lambda: att.flash_attention_plain(*args))
        print(f"    kernel ms {ms:.4f} plain_ms {pms:.4f} (the plain path "
              f"takes it now)")
    b_ms, b_by = bound(prep["flops"], prep["bytes"])
    print(f"  K3 at prepare_sds's shapes, summed over its {prep['launches']} "
          f"launches: ms {prep['ms']:.3f} plain_ms {prep['plain_ms']:.3f} "
          f"library_ms {prep['library_ms']:.3f} (SDPA) bound_ms {b_ms:.3f} "
          f"({b_by}); device time {prep['device_ms']:.3f} ms (SDPA "
          f"{prep['library_device_ms']:.3f})")
    for kn, (dms, dlms) in step.items():
        print(f"  K{kn} at the step's shapes, summed over its launches: "
              f"device time {dms:.3f} ms (SDPA {dlms:.3f})")


@contextlib.contextmanager
def routed_attention_calls():
    """While active, record the (q, k, v, extra_k, extra_v) of every
    attention() call of the attention layers that routes to the kernel, as
    the layers pass them (views, not copies)."""
    from contexture_nerf_tpu_torch.diffusion import layers
    from contexture_nerf_tpu_torch.ops import attention as att

    calls, orig = [], layers.attention

    def record(q, k, v, extra_k=None, extra_v=None):
        se = 0 if extra_k is None else extra_k.shape[2]
        if q.is_cuda and att.routes_to_kernel(q.shape[2], k.shape[2], se):
            calls.append((q, k, v, extra_k, extra_v))
        return orig(q, k, v, extra_k=extra_k, extra_v=extra_v)

    layers.attention = record
    try:
        yield calls
    finally:
        layers.attention = orig


def check_routed_calls(torch, calls, label, failures):
    """K3/K4 held to attention_limit on every recorded kernel-routed call's
    real inputs. Returns (max |kernel - plain|, K3 calls, K4 calls)."""
    from contexture_nerf_tpu_torch.ops import attention as att

    worst = err = 0.0
    strided = 0
    with torch.no_grad():
        for args in calls:
            got = att.flash_attention(*args)
            plain = att.flash_attention_plain(*args)
            limit = attention_limit(torch, *args, plain)
            worst = max(worst, attention_ratio(torch, got, plain, limit))
            err = max(err, float((got.float() - plain.float()).abs().max()))
            strided += not all(t.is_contiguous() for t in args
                               if t is not None)
    two = sum(1 for a in calls if a[3] is not None)
    print(f"  K3/K4 on the {len(calls)} kernel-routed attention calls of "
          f"{label} ({len(calls) - two} K3, {two} K4; real activations, "
          f"{strided} of them strided views): largest err/limit "
          f"{worst:.3f}, max_abs_err {err:.3e}")
    if not worst <= 1.0:
        failures.append(f"K3/K4 on {label}: err/limit {worst:.3f}")
    return err, len(calls) - two, two


def activations(torch, shape, dtype, gen):
    """An activation-like input: per-channel means 0.5 + 0.5 N(0, 1) and
    scales 0.5 + U(0, 1), so the mean is nonzero and the channels of a
    group differ (a shifted group boundary changes the statistics)."""
    C, dev = shape[1], gen.device
    cs = (1, C) + (1,) * (len(shape) - 2)
    mu = 0.5 + 0.5 * torch.randn((C,), generator=gen, device=dev)
    sd = 0.5 + torch.rand((C,), generator=gen, device=dev)
    x = torch.randn(shape, generator=gen, device=dev) * sd.reshape(cs)
    return (x + mu.reshape(cs)).to(dtype)


def planted_group_norm(torch, x, scale, bias, groups, eps, act, out_dtype,
                       fault):
    """The plain GroupNorm(+SiLU) with one planted fault, a stand-in for a
    wrong K6: "boundary" takes each group's statistics over channels shifted
    by one; "no_silu" drops the SiLU; "chunk" leaves one CTA's share out of
    the cluster's statistics, still dividing by n: the middle rank's chunk
    of K6's plan, or for a one-CTA plan its middle bulk-copy piece (all of
    the group when it is one piece)."""
    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    B, C = x.shape[:2]
    xf = x.float()
    src = (xf.roll(-1, dims=1) if fault == "boundary" else xf).reshape(
        B, groups, -1)
    n = src.shape[-1]
    if fault == "chunk":
        p = gn.plan(n, B * groups, x.element_size(), max_cluster=(
            gn.max_cluster() if x.is_cuda else gn.MAX_CLUSTER))
        share = (p.chunk if p.cluster > 1
                 else gn.PIECE_BYTES // x.element_size())
        parts = -(-n // share)
        keep = torch.ones(n, device=x.device)
        keep[(parts // 2) * share:(parts // 2 + 1) * share] = 0
        src = src * keep
    mean = src.sum(-1, keepdim=True) / n
    var = (src * src).sum(-1, keepdim=True) / n - mean * mean
    y = ((xf.reshape(B, groups, -1) - mean) * torch.rsqrt(var + eps)
         ).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if act and fault != "no_silu":
        y = y * torch.sigmoid(y)
    return y.to(out_dtype)


def statistics_floor(torch, x, scale, groups, eps, act, rho=2.0 ** -14):
    """The part of |K6 - plain| that the rounding of the f32 statistics can
    cause, per element of x (f32, shaped like x). Both sum in f32 trees,
    each in its own order; with every term rounded at most 1024 times on its
    way into a sum, the mean and E[x^2] each err by at most rho = 2^-14
    (1024 f32 ulps) of mean|x| and of E[x^2]. Propagated through
    (x - mean) * rstd * scale (d rstd = rstd^3 d var / 2) and the SiLU's
    slope (< 1.1), and doubled, since both sides err."""
    B, C = x.shape[:2]
    xd = x.double().reshape(B, groups, -1)
    mean = xd.mean(-1, keepdim=True)
    m_abs = xd.abs().mean(-1, keepdim=True)
    e2 = (xd * xd).mean(-1, keepdim=True)
    rstd = torch.rsqrt((e2 - mean * mean).clamp(min=0) + eps)
    d_mean = rho * m_abs
    d_var = rho * (e2 + 2.0 * mean.abs() * m_abs)
    d = d_mean * rstd + (xd - mean).abs() * (0.5 * d_var * rstd ** 3)
    shape = (1, C) + (1,) * (x.dim() - 2)
    d = d.reshape(x.shape) * scale.double().abs().reshape(shape)
    return (2.0 * (1.1 if act else 1.0) * d).float()


def groupnorm_limit(torch, x, scale, bias, groups, eps, act, plain):
    """K6's per-element limit against its plain output `plain`: for bf16
    output one bf16 ulp at the plain output's magnitude (the two round f32
    values that differ only by the statistics' rounding) plus
    `statistics_floor` for the values near zero; for f32 output 4x the
    plain f32 path's own largest distance from the same formula in f64
    (both sides err by the statistics' and the elementwise rounding)."""
    if plain.dtype == torch.bfloat16:
        a = plain.float().abs().clamp(min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7.0)
        return ulp + statistics_floor(torch, x, scale, groups, eps, act)
    B, C = x.shape[:2]
    xd = x.double().reshape(B, groups, -1)
    mean = xd.mean(-1, keepdim=True)
    var = (xd * xd).mean(-1, keepdim=True) - mean * mean
    y = ((xd - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = y * scale.double().reshape(shape) + bias.double().reshape(shape)
    if act:
        y = y * torch.sigmoid(y)
    noise = float((plain.double() - y).abs().max())
    return torch.full_like(plain, 4.0 * noise, dtype=torch.float32)


def groupnorm_bytes(torch, x, out_dtype):
    """Bytes one GroupNorm(+SiLU) call must move: x read once, y written
    once (K6's two passes read x twice, 1.5x this for bf16 in and out)."""
    return x.numel() * (x.element_size()
                        + torch.empty((), dtype=out_dtype).element_size())


def groupnorm_ratio(torch, got, plain, limit):
    """max |got - plain| / limit over the elements (<= 1 passes)."""
    return float(((got.float() - plain.float()).abs() / limit).max())


def pixel_face_pairs(torch, fvi, H, W):
    """(pixel, face) pairs whose face box covers the pixel centre: the work
    the rasterizer must do for these faces (every such pair gets its edge
    functions evaluated)."""
    from contexture_nerf_tpu_torch.raster.rasterize import pixel_centers

    ys, xs = pixel_centers(H, W, fvi.device)
    ys = ys.flip(0).contiguous()  # ascending

    def count(axis, lo, hi):
        return (torch.searchsorted(axis, hi.contiguous(), right=True)
                - torch.searchsorted(axis, lo.contiguous())).clamp(min=0)

    x, y = fvi[..., 0], fvi[..., 1]
    n = count(xs, x.amin(-1), x.amax(-1)) * count(ys, y.amin(-1), y.amax(-1))
    return float(n.double().sum())


def numpy_uv_sphere(n_lat, n_lon):
    """A UV sphere of 2 n_lon (n_lat - 1) faces (vertices (N, 3) f32,
    faces (F, 3) i64), built with numpy."""
    import numpy as np

    th = np.pi * np.arange(n_lat + 1) / n_lat
    ph = 2 * np.pi * np.arange(n_lon + 1) / n_lon
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                     -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    a, b = i * (n_lon + 1) + j, i * (n_lon + 1) + j + 1
    c, d = a + n_lon + 1, b + n_lon + 1
    upper = np.stack([a, c, b], -1)[1:].reshape(-1, 3)
    lower = np.stack([b, c, d], -1)[:-1].reshape(-1, 3)
    return verts, np.concatenate([upper, lower]).astype(np.int64)


def binned_plain(torch, fvz, fvi, H, W, ranges, face_chunk=64):
    """The plain rasterizer with each face tested only at the pixels of its
    tile range (`ranges` (B, F, 4) int32 [tx0 tx1 ty0 ty1], inclusive):
    what K5 computes from those ranges, in plain torch. With the setup's
    own ranges it equals the plain version bit for bit."""
    from contexture_nerf_tpu_torch.raster.raster_kernel import TILE
    from contexture_nerf_tpu_torch.raster.rasterize import (
        EPS, face_edge_setup, pixel_centers)

    B, F = fvz.shape[:2]
    dev = fvz.device
    ca, cb, cc, den = face_edge_setup(fvi.float())
    valid = den.abs() > EPS
    den_safe = torch.where(den.abs() < EPS, torch.ones_like(den), den)
    ys, xs = pixel_centers(H, W, dev)
    px, py = xs.repeat(H)[:, None], ys.repeat_interleave(W)[:, None]
    tx = (torch.arange(W, device=dev) // TILE).repeat(H)[:, None]
    ty = (torch.arange(H, device=dev) // TILE).repeat_interleave(W)[:, None]
    P = H * W
    face_idx = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((B, P, 3), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for b in range(B):
        best_z = torch.full((P,), float("-inf"), device=dev)
        for s in range(0, F, face_chunk):
            e = min(s + face_chunk, F)
            r = ranges[b, s:e]
            w = [(px * ca[b, s:e, k] + py * cb[b, s:e, k] + cc[b, s:e, k])
                 / den_safe[b, s:e] for k in range(3)]
            inside = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0) & \
                valid[b, s:e] & (r[:, 0] <= tx) & (tx <= r[:, 1]) & \
                (r[:, 2] <= ty) & (ty <= r[:, 3])
            zz = fvz[b, s:e].float()
            z = w[0] * zz[:, 0] + w[1] * zz[:, 1] + w[2] * zz[:, 2]
            z = torch.where(inside, z, neg_inf)
            arg = torch.argmax(z, dim=1)
            cand_z = z.gather(1, arg[:, None])[:, 0]
            better = cand_z > best_z
            best_z = torch.where(better, cand_z, best_z)
            face_idx[b] = torch.where(better, (s + arg).to(torch.int32),
                                      face_idx[b])
            cand = torch.stack([wk.gather(1, arg[:, None])[:, 0] for wk in w],
                               dim=-1)
            bary[b] = torch.where(better[:, None], cand, bary[b])
    return face_idx.reshape(B, H, W), bary.reshape(B, H, W, 3)


def shrunk_ranges(ranges):
    """The planted binning fault: every tile range that spans two or more
    tile columns loses its last one (an off-by-one at the upper edge)."""
    out = ranges.clone()
    out[..., 1] -= (out[..., 1] > out[..., 0]).to(out.dtype)
    return out


def raster_cases(torch, cfg):
    """K5's cases: (name, fvz, fvi, H, W, checked at (views, H, W) or None
    for the case's own size, timed). The torus's 7 views at 1200^2 (the
    main path's launch), a 50,880-face sphere on one 1200^2 view, a
    500,000-face sphere (checked on one view at 384^2, timed on 7 at
    1200^2) and the torus at a ragged 777 x 1234."""
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel
    from contexture_nerf_tpu_torch.training.trainer import view_angles

    dev = torch.device("cuda")
    res = cfg.render.train_grid_size
    mm = TexturedMeshModel(cfg.guide, render_grid_size=res, device=dev)
    th, ph, r = view_angles(cfg.render)
    _, fvc, torus_fvi, _ = mm.project(th, ph, r)
    torus_z = fvc[..., 2].contiguous()

    def sphere(n_lat, n_lon, views):
        v, f = numpy_uv_sphere(n_lat, n_lon)
        v = torch.from_numpy(v * 0.6).to(dev)
        v[:, 1] += 0.25
        _, fvc, fvi, _ = mm.renderer.project(
            v, torch.from_numpy(f).to(dev), th[:views], ph[:views],
            r[:views], 0.25)
        return f"sphere {f.shape[0]} faces", fvc[..., 2].contiguous(), fvi

    return [("torus 7 views", torus_z, torus_fvi, res, res, None, True),
            sphere(160, 160, 1) + (res, res, None, True),
            sphere(501, 500, 7) + (res, res, (1, 384, 384), True),
            ("torus 2 views ragged", torus_z[:2], torus_fvi[:2], 777, 1234,
             None, False)]


def raster_times(torch, fn, fvz, fvi, H, W):
    """(event ms of a call, {kernel: device ms a call})."""
    return (cuda_ms(lambda: fn(fvz, fvi, H, W)),
            device_ms_by_kernel(lambda: fn(fvz, fvi, H, W)))


def times_line(ms, dev):
    """Event ms and device ms of a K5 call: the raster kernels by name, the
    other device work (PyTorch's kernels, copies) summed."""
    total = sum(dev.values()) if dev else float("nan")
    own = {k.replace("(anonymous namespace)::", "").split("(")[0]: v
           for k, v in dev.items() if "raster" in k}
    rest = [v for k, v in dev.items() if "raster" not in k]
    parts = [f"{k} {v:.4f}" for k, v in own.items()]
    if rest:
        parts.append(f"{len(rest)} other kernels and copies {sum(rest):.4f}")
    return f"event {ms:.4f} ms, device {total:.4f} ms ({', '.join(parts)})"


def raster_phases(torch, rec, cfg, failures):
    """K5 against its plain version in every case of `raster_cases`: the
    setup's records and pixel ranges against `face_records` and
    `pixel_ranges` (torch.equal), the outputs against the plain version
    (`agreement_ok`) and across two runs (torch.equal). The timed cases
    print event and device time by kernel. Three planted faults run
    through plain emulations on the torus."""
    from contexture_nerf_tpu_torch.raster import raster_kernel as rk
    from contexture_nerf_tpu_torch.raster.rasterize import rasterize_geometry

    t_phase = time.perf_counter()
    for name, fvz, fvi, H, W, check_at, timed in raster_cases(torch, cfg):
        cz, ci, cH, cW = fvz, fvi, H, W
        if check_at is not None:
            views, cH, cW = check_at
            cz, ci = fvz[:views], fvi[:views]
        B, F = cz.shape[:2]
        rec_k, ranges_k, nt_k = rk.face_setup(cz, ci, cH, cW)
        rec_p, box_p = rk.face_records(cz, ci)
        setup_same = torch.equal(rec_k, rec_p) and \
            torch.equal(ranges_k, rk.pixel_ranges(box_p, cH, cW)) and \
            torch.equal(nt_k, rk.range_tiles(rk.tile_ranges(box_p, cH, cW)))
        idx, bary = rk.rasterize_geometry_kernel(cz, ci, cH, cW)
        idx2, bary2 = rk.rasterize_geometry_kernel(cz, ci, cH, cW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_idx, p_bary = rasterize_geometry(
            cz, ci, cH, cW, face_chunk=64 if F < 100_000 else 1024)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        a = rk.raster_agreement(idx, bary, p_idx, p_bary, cz)
        same = torch.equal(idx, idx2) and torch.equal(bary, bary2)
        exact = torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
        ok = rk.agreement_ok(a) and same and setup_same
        label = f"K5 raster {name} ({B}x{cH}x{cW}, F={F})"
        print(f"  {label}: face_idx agree {a['agree']:.6f} on {a['covered']} "
              f"covered px, {a['mismatch']} mismatched ({a['unexplained']} "
              f"neither a z tie <= 1e-6 nor an edge <= 1e-5), bary max err "
              f"{a['bary_err']:.3e} (tol 1e-5), two runs bit-identical "
              f"{same}, bit-identical to plain {exact}; setup records and "
              f"pixel ranges equal face_records and pixel_ranges "
              f"{setup_same}; "
              f"{int(nt_k.sum())} (tile, face) list entries; plain "
              f"{pms:.1f} ms (one run) {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(label)
        rec.add(a["bary_err"], 0.0, 0.0, 0.0, 0.0, times=0)
        del rec_k, rec_p, idx, bary, idx2, bary2, p_idx, p_bary
        if not timed:
            continue
        B, F = fvz.shape[:2]
        ms, dev = raster_times(torch, rk.rasterize_geometry_kernel, fvz, fvi,
                               H, W)
        pairs = pixel_face_pairs(torch, fvi, H, W)
        entries = int(rk.face_setup(fvz, fvi, H, W)[2].sum())
        # the function's bytes: 16 B a pixel out, fvz + fvi (36 B) a face a
        # view in
        nbytes = B * H * W * 16 + B * F * 36
        b_ms, by = bound(20.0 * pairs, nbytes, H100_FP32_FLOPS)
        print(f"    {name} at {B}x{H}x{W}: {times_line(ms, dev)}; bound "
              f"{b_ms:.4f} ms ({by}); {pairs:.4g} (pixel, face) pairs in a "
              f"face box ({pairs / (B * H * W):.2f} a pixel), {entries} "
              f"(tile, face) list entries")
        if name != "torus 7 views":
            continue
        pms = cuda_ms(lambda: rasterize_geometry(fvz, fvi, H, W), reps=2,
                      warmup=1)
        print(f"    plain_ms {pms:.3f} (median of 2 after a warm-up)")
        rec.add(a["bary_err"], ms, pms, 20.0 * pairs, nbytes)
        p_idx, p_bary = rasterize_geometry(fvz, fvi, H, W)
        _, box = rk.face_records(fvz, fvi)
        ranges = rk.tile_ranges(box, H, W)
        for fault, (fz, fi, rg) in {
                "z test reversed (farthest face wins)": (-fvz, fvi, ranges),
                "last 64-face chunk dropped": (fvz[:, :-64], fvi[:, :-64],
                                               ranges[:, :-64]),
                "tile ranges one column short at the upper edge":
                    (fvz, fvi, shrunk_ranges(ranges)),
        }.items():
            b = rk.raster_agreement(*binned_plain(torch, fz, fi, H, W, rg),
                                    p_idx, p_bary, fvz)
            caught = not rk.agreement_ok(b)
            print(f"    planted fault {fault}: agree {b['agree']:.6f}, "
                  f"{b['unexplained']} unexplained "
                  f"{'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                failures.append(f"K5 limits pass planted fault {fault}")
    print(f"  K5 phase {time.perf_counter() - t_phase:.1f} s")


def raster_times_of(torch, root):
    """Event and device time by kernel of the K5 wrapper of the checkout
    at `root` (imported from there) in the timed cases; one JSON line."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.raster import raster_kernel as rk

    cfg = config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})
    out = {"root": str(root), "card": card_line()}
    for name, fvz, fvi, H, W, _, timed in raster_cases(torch, cfg):
        if timed:
            ms, dev = raster_times(torch, rk.rasterize_geometry_kernel, fvz,
                                   fvi, H, W)
            out[name] = {"shape": [fvz.shape[0], H, W], "ms": ms,
                         "device": dev}
    print(json.dumps(out))


def raster_against(other, failures):
    """K5 of the checkout at `other` and of this one, timed in turns in
    subprocesses on this card: other, this, this, other."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--k5-times-of", str(root)], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            failures.append(f"K5 timing of {root} failed: "
                            f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
            return
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    print(f"K5 timed in turns (this checkout: {ROOT}; other: {other}) "
          f"[{runs[0]['card']}]:")
    for run in runs:
        which = "this " if Path(run["root"]) == ROOT else "other"
        for name, d in run.items():
            if isinstance(d, dict):
                print(f"  {which} {name} {'x'.join(map(str, d['shape']))}: "
                      f"{times_line(d['ms'], d['device'])}")


# (label, x shape, x dtype, out dtype, eps, act) of the K6 phase: the
# bootstrap's UNet (64^2 latent, 320-1280 channels) and 512^2 decoder, the
# SDS step's UNet (120x80 latent) and canvas encoder (960x640), and ragged
# shapes off the 16-byte pack
GN_SHAPES = [
    ("bootstrap UNet resnet", (2, 320, 64, 64), "bf16", "bf16", 1e-5, True),
    ("bootstrap UNet resnet, f32 stream", (2, 640, 32, 32), "f32", "bf16",
     1e-5, True),
    ("bootstrap UNet transformer", (2, 640, 32, 32), "bf16", "bf16", 1e-6,
     False),
    ("bootstrap UNet mid", (2, 1280, 8, 8), "bf16", "bf16", 1e-5, True),
    ("decoder 512^2", (1, 128, 512, 512), "bf16", "bf16", 1e-6, True),
    ("decoder 512^2, 256 channels", (1, 256, 512, 512), "bf16", "bf16",
     1e-6, True),
    ("decoder 256^2", (1, 512, 256, 256), "bf16", "bf16", 1e-6, True),
    ("step UNet resnet", (2, 320, 120, 80), "bf16", "bf16", 1e-5, True),
    ("step encoder 960x640", (1, 128, 960, 640), "bf16", "bf16", 1e-6, True),
    ("ragged f32", (1, 96, 7, 13), "f32", "f32", 1e-5, True),
    ("ragged bf16 -> f32", (2, 64, 5, 9), "bf16", "f32", 1e-6, False),
    ("ragged f32 -> bf16", (1, 64, 33, 17), "f32", "bf16", 1e-5, True),
]
FAULTS = {"boundary": "group boundary shifted by one channel",
          "no_silu": "SiLU dropped",
          "chunk": "one CTA's share left out of the cluster's statistics"}


def groupnorm_phase(torch, seed, failures):
    """K6 against its plain version at GN_SHAPES on activation-like inputs
    (nonzero, per-channel means): within groupnorm_limit on every element,
    two runs bit-identical, the planted faults outside the limit; and the
    autograd path's gradients against the plain path's."""
    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    worst = 0.0
    for label, shape, dt, odt, eps, act in GN_SHAPES:
        x = activations(torch, shape, dts[dt], gen)
        C = shape[1]
        scale = 1 + 0.3 * torch.randn((C,), generator=gen, device=dev)
        bias = 0.2 * torch.randn((C,), generator=gen, device=dev)
        if odt == "bf16":  # the bf16 towers' parameters are bf16
            scale, bias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        args = (scale, bias, 32, eps, act, dts[odt])
        p = gn.kernel_plan(x)
        got = gn.group_norm_silu_kernel(x, *args)
        same = torch.equal(got, gn.group_norm_silu_kernel(x, *args))
        plain = gn.group_norm_silu_plain(x, *args)
        limit = groupnorm_limit(torch, x, scale, bias, 32, eps, act, plain)
        ratio = groupnorm_ratio(torch, got, plain, limit)
        err = float((got.float() - plain.float()).abs().max())
        worst = max(worst, err)
        ok = ratio <= 1.0 and same and bool(torch.isfinite(got.float()).all())
        name = (f"K6 groupnorm {label} {shape} {dt}->{odt} eps {eps} act "
                f"{act} [{p.path}, {p.cluster} CTA{'s' * (p.cluster > 1)}]")
        what = ("1 bf16 ulp + statistics floor" if odt == "bf16"
                else "4x plain f32 vs f64")
        print(f"  {name}: max_abs_err {err:.3e}, max err/limit {ratio:.3f} "
              f"(limit: {what}), two runs bit-identical {same} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(name)
        if not (act and dt == odt == "bf16"):
            continue
        for fault, what in FAULTS.items():
            bad = planted_group_norm(torch, x, *args, fault)
            r = groupnorm_ratio(torch, bad, plain, limit)
            print(f"    planted fault {what}: max err/limit {r:.2f} "
                  f"{'caught' if r > 1 else 'NOT CAUGHT'}")
            if not r > 1:
                failures.append(f"{name}: limit passes planted fault {fault}")
    x = activations(torch, (2, 320, 24, 20), torch.float32, gen)
    scale = 1 + 0.3 * torch.randn((320,), generator=gen, device=dev)
    bias = 0.2 * torch.randn((320,), generator=gen, device=dev)
    w = torch.randn(x.shape, generator=gen, device=dev)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
        (fn(*ins, 32, 1e-6, True, torch.float32) * w).sum().backward()
        return [t.grad for t in ins]

    g_k, g_p = grads(gn.group_norm_silu), grads(gn.group_norm_silu_plain)
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    print(f"  K6 autograd (forward K6, backward through the plain version): "
          f"gradients vs the plain path's max_abs_err {g_err:.3e} (tol 1e-5)")
    if not g_err <= 1e-5:
        failures.append("K6 autograd gradients")
    return worst


def check_setup(torch, setup, trainer, res, failures):
    """prepare_sds's outputs: the shapes at full width, finite values, an
    object on the canvas, UVs in [0, 1], probabilities that sum to 1, and
    the bootstrapped front view (res x res) in [0, 1]."""
    t = trainer.tile_px
    shapes = {"depth_grid": (1, 3, 3 * t, 2 * t),
              "mask_grid": (1, 1, 3 * t, 2 * t),
              "uv_grid_pts": (6 * t * t, 2), "cond_image": (1, 3, t, t),
              "cond_lat_pair": (2, 4, t // 8, t // 8),
              "encoder_hidden_states": (2, 77, 1024), "tile_probs": (6,),
              "front_rgb": (1, 3, res, res)}
    for k, shape in shapes.items():
        x = setup[k]
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            failures.append(f"prepare_sds {k}: shape {tuple(x.shape)} "
                            f"(want {shape}) or non-finite")
    m = setup["mask_grid"]
    uv = setup["uv_grid_pts"]
    f = setup["front_rgb"]
    ok = (float(m.max()) > 0.99 and float(m.min()) < 0.01
          and float(uv.min()) >= 0 and float(uv.max()) <= 1
          and float(f.min()) >= 0 and float(f.max()) <= 1
          and abs(float(setup["tile_probs"].sum()) - 1) < 1e-5
          and len(setup["bboxes6"]) == 6)
    print(f"  setup: bootstrapped front view {tuple(f.shape)} in "
          f"[{float(f.min()):.4f}, {float(f.max()):.4f}] mean "
          f"{float(f.mean()):.4f}, mask_grid mean {float(m.mean()):.4f}, "
          f"cond_image mean {float(setup['cond_image'].mean()):.4f}, "
          f"depth_grid mean {float(setup['depth_grid'].mean()):.4f}, "
          f"tile_probs {[round(float(p), 4) for p in setup['tile_probs']]}, "
          f"bboxes6 {setup['bboxes6']} {'ok' if ok else 'BAD'}")
    if not ok:
        failures.append("prepare_sds outputs out of range")


def groupnorm_traffic(torch, modules, run):
    """The GroupNorm(+SiLU) calls of `run()` in the GroupNormSiLU modules of
    `modules`: their count, the bytes the calls must move (read x once,
    write y once), the least time the card could take (bytes; their ~12
    FP32 operations an element need less), the stream time between CUDA
    events around each call (launch gaps included), and the calls grouped
    by signature (shape, dtypes, eps, act) -> [count, a sample call's
    (x, scale, bias, groups, eps, act, out_dtype)]."""
    from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

    calls, sigs = [], {}

    def pre(mod, inp):
        x = inp[0]
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        key = (tuple(x.shape), x.dtype, mod.out_dtype, mod.eps, mod.act)
        if key not in sigs:
            sigs[key] = [0, (x.detach().clone(), mod.weight.detach(),
                             mod.bias.detach(), mod.groups, mod.eps, mod.act,
                             mod.out_dtype)]
        sigs[key][0] += 1
        calls.append([groupnorm_bytes(torch, x, mod.out_dtype), x.numel(),
                      ev])

    def post(mod, inp, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls[-1].append(ev)

    mods = [m for mod in modules for m in mod.modules()
            if isinstance(m, GroupNormSiLU)]
    hooks = [h for m in mods for h in (m.register_forward_pre_hook(pre),
                                       m.register_forward_hook(post))]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    nbytes = sum(c[0] for c in calls)
    b_ms, b_by = bound(12.0 * sum(c[1] for c in calls), nbytes,
                       H100_FP32_FLOPS)
    return {"calls": len(calls), "bytes": nbytes, "bound_ms": b_ms,
            "bound_by": b_by,
            "stream_ms": sum(c[2].elapsed_time(c[3]) for c in calls),
            "sigs": sigs}


def host_us(torch, fn, reps=20):
    """Host microseconds a call of fn() takes to return (the wrapper's work
    and the launches, without waiting for the card), averaged over reps."""
    fn()
    torch.cuda.synchronize()
    a = time.perf_counter()
    for _ in range(reps):
        fn()
    b = time.perf_counter()
    torch.cuda.synchronize()
    return (b - a) / reps * 1e6


def groupnorm_signature_times(torch, sigs, failures, label):
    """K6, its plain version and the library's F.group_norm (+ F.silu: two
    calls) timed at each signature's sample input (a real activation of the
    main path), and K6 held against the plain version there within
    groupnorm_limit. Each signature is timed with CUDA events (cuda_ms), as
    device time (profiler) and as host microseconds a call, K6's and the
    library's; the path of K6's plan is noted. Prints the sums by path and
    the largest signatures, writes every signature's row to
    chiprun_out/k6_signatures_<label>.txt, and returns (ms, plain_ms,
    library_ms, max_abs_err, device_ms, library_device_ms), each summed over
    the signatures' calls."""
    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    tot = dict.fromkeys(("ms", "pms", "lms", "dms", "ldms"), 0.0)
    err = worst = 0.0
    rows, paths = [], {}
    for (shape, dt, odt, eps, act), (n, args) in sigs.items():
        x, scale, bias, groups = args[:4]
        got = gn.group_norm_silu_kernel(*args)
        plain = gn.group_norm_silu_plain(*args)
        limit = groupnorm_limit(torch, x, scale, bias, groups, eps, act,
                                plain)
        ratio = groupnorm_ratio(torch, got, plain, limit)
        worst = max(worst, ratio)
        err = max(err, float((got.float() - plain.float()).abs().max()))
        if not ratio <= 1.0:
            failures.append(f"K6 at main-path shape {shape}: err/limit "
                            f"{ratio:.3f}")
        w, b = scale.to(x.dtype), bias.to(x.dtype)

        def lib():
            y = F.group_norm(x, groups, w, b, eps)
            return F.silu(y) if act else y

        def k6():
            return gn.group_norm_silu_kernel(*args)

        t = {"ms": cuda_ms(k6), "lms": cuda_ms(lib),
             "pms": cuda_ms(lambda: gn.group_norm_silu_plain(*args), reps=5),
             "dms": device_ms(k6), "ldms": device_ms(lib)}
        hu, lhu = host_us(torch, k6), host_us(torch, lib)
        for k in tot:
            tot[k] += n * t[k]
        nbytes = groupnorm_bytes(torch, x, odt)
        b_ms = nbytes / H100_BYTES_S * 1e3
        path = gn.kernel_plan(x, groups)
        agg = paths.setdefault(path.path, [0, 0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, n, n * t["dms"], n * t["ldms"],
                               n * b_ms)):
            agg[i] += v
        rows.append((n * nbytes, n, shape, str(dt)[6:], str(odt)[6:],
                     path.path, path.cluster, t, hu, lhu, b_ms))
    print(f"    K6 held to its limit at {len(sigs)} shapes: largest "
          f"err/limit {worst:.3f}")
    for path, (k, n, d, ld, b_ms) in sorted(paths.items()):
        print(f"    path {path}: {k} shapes, {n} calls; device time K6 "
              f"{d:.3f} ms, library {ld:.3f}, bound {b_ms:.3f} (bytes); K6 "
              f"at {100 * b_ms / d:.0f}% of the bound")
    lines = []
    for nb, n, shape, dt, odt, path, cs, t, hu, lhu, b_ms in sorted(
            rows, key=lambda r: r[0], reverse=True):
        lines.append(
            f"{n} x {shape} {dt}->{odt} [{path}, {cs} CTA{'s' * (cs > 1)}]: "
            f"K6 {t['ms']:.4f} ms (device {t['dms']:.4f}, host "
            f"{hu:.1f} us), library {t['lms']:.4f} (device "
            f"{t['ldms']:.4f}, host {lhu:.1f} us), plain {t['pms']:.4f}, "
            f"bound {b_ms:.4f} (bytes) a call; device time at "
            f"{100 * b_ms / t['dms']:.0f}% of the bound")
    for line in lines[:6]:
        print("    " + line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"k6_signatures_{label}.txt").write_text("\n".join(lines) + "\n")
    return (tot["ms"], tot["pms"], tot["lms"], err, tot["dms"],
            tot["ldms"])


def main_path(torch, seed, profile, recs, failures):
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.diffusion.sd_depth import \
        StableDiffusionDepth
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops import groupnorm as gn
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = config_from_dict({"optim": {"seed": seed}, "guide": {
        "text": "a photo of a dairy cow",
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})
    timings = {}
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = StableDiffusionDepth(
        device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    n_sd = sum(p.numel() for p in sd.parameters())
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, setup = tr.build_sds_trainer(cfg, device="cuda",
                                          timings=timings, diffusion=sd)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    prep = dict(_build.launch_counts)
    prep_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in trainer.teacher.parameters())
    n_clip = sum(p.numel() for m in (trainer.teacher.text_encoder,
                                     trainer.teacher.vision_encoder)
                 for p in m.parameters())
    prep_ms = sum(timings.values())
    boot_ms = sum(v for k, v in timings.items() if k.startswith("bootstrap"))
    print(f"  SD2-depth stack (UNet, inpaint UNet, VAE, text tower) "
          f"{n_sd / 1e6:.1f} M params in {sd.dtype}, random init "
          f"{sd_s:.1f} s")
    print(f"  build_sds_trainer (teacher init + prepare_sds + trainer) "
          f"{built_s:.1f} s: teacher {n_params / 1e6:.1f} M params "
          f"({n_clip / 1e6:.1f} M of them CLIP) in {trainer.dtype}, canvas "
          f"{trainer.grid_hw}, backward slice {trainer.sl_h}x{trainer.sl_w}")
    print(f"  prepare_sds {prep_ms:.1f} ms (bootstrap {boot_ms:.1f}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
          + f" ms; peak memory {prep_peak:.2f} GiB; launches "
          f"{json.dumps(prep)}")
    want = tr.prepare_sds_kernel_launches(cfg, trainer.teacher, sd)
    print(f"  expected launches of prepare_sds: {json.dumps(want)}")
    if prep != want:
        failures.append(f"prepare_sds launches {prep} != {want}")
    check_setup(torch, setup, trainer, cfg.render.train_grid_size, failures)

    # K6's share of prepare_sds, from one more call of each part with the
    # GroupNorms hooked: 51 UNet calls, the decode, the two condition encodes
    steps = len(sd.scheduler.timesteps(tr.BOOTSTRAP_STEPS))
    lat = torch.randn(sd.latent_shape(), device=dev)
    lat_in = torch.cat([torch.cat([lat] * 2), torch.randn(
        (2, 1) + sd.latent_shape()[2:], device=dev)], 1)
    text = sd.get_text_embeds([cfg.guide.text])
    with torch.no_grad(), routed_attention_calls() as boot_calls:
        parts = {
            "UNet call": (steps, groupnorm_traffic(
                torch, [sd.unet], lambda: sd.unet(lat_in, 981, text))),
            "decode": (1, groupnorm_traffic(
                torch, [sd.vae_decoder], lambda: sd.decode_latents(lat))),
            "condition encodes": (1, groupnorm_traffic(
                torch, [trainer.teacher.vae_encoder],
                lambda: trainer.teacher.encode_condition_pair(
                    setup["cond_image"] * 2 - 1,
                    *tr.condition_eps(trainer.teacher, torch.Generator(
                        device=dev).manual_seed(seed))))),
        }
    p_calls = sum(n * t["calls"] for n, t in parts.values())
    p_bytes = sum(n * t["bytes"] for n, t in parts.values())
    p_stream = sum(n * t["stream_ms"] for n, t in parts.values())
    p_bound = sum(n * t["bound_ms"] for n, t in parts.values())
    print(f"  K6 in prepare_sds: {p_calls} calls ("
          + ", ".join(f"{n} x {t['calls']} a {k}" for k, (n, t) in
                      parts.items())
          + f"), {p_bytes / 1e9:.3f} GB to move, bound_ms {p_bound:.3f} "
          f"(bytes), K6 stream time {p_stream:.2f} ms (CUDA events around "
          "each call, launch gaps included)")
    if p_calls * gn.LAUNCHES_PER_CALL != want["groupnorm"]:
        failures.append(f"K6 launches in prepare_sds "
                        f"{p_calls * gn.LAUNCHES_PER_CALL} != "
                        f"{want['groupnorm']}")
    # K6 held against its plain version at every signature of prepare_sds;
    # the times are printed here and kept out of the per-step record
    sigs = {}
    for n, t in parts.values():
        for key, (c, args) in t["sigs"].items():
            sigs.setdefault(key, [0, args])[0] += n * c
    ms, pms, lms, err, dms, ldms = groupnorm_signature_times(
        torch, sigs, failures, "prepare_sds")
    recs["groupnorm"].d["max_abs_err"] = max(
        recs["groupnorm"].d["max_abs_err"], err)
    print(f"  K6 at prepare_sds's {len(sigs)} shapes, timed alone and summed "
          f"over its calls: ms {ms:.3f} plain_ms {pms:.3f} library_ms "
          f"{lms:.3f} bound_ms {p_bound:.3f}; device time K6 {dms:.3f} ms, "
          f"library {ldms:.3f}; max_abs_err {err:.3e}")
    # K3 on the bootstrap UNet call's real self-attention inputs
    err, single, _ = check_routed_calls(torch, boot_calls,
                                        "a bootstrap UNet call", failures)
    recs["flash_attn_single"].d["max_abs_err"] = max(
        recs["flash_attn_single"].d["max_abs_err"], err)
    if steps * single != want["flash_attn_single"]:
        failures.append(f"K3 in prepare_sds: {steps} x {single} routed calls "
                        f"!= {want['flash_attn_single']}")
    del sd, parts, sigs, lat, lat_in, text, boot_calls
    torch.cuda.empty_cache()

    expected = trainer.expected_kernel_launches()
    print(f"  expected launches per step: {json.dumps(expected)}")
    init = {k: v.clone() for k, v in trainer.mlp.state_dict().items()}
    ts = trainer.t_schedule(1000).tolist()[100:104]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms, losses = [], []
    for i, t in enumerate(ts):
        before = dict(_build.launch_counts)
        torch.cuda.synchronize()
        a = time.perf_counter()
        params, loss, gnorm, fisher, grid = trainer.step(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - a) * 1e3
        delta = {k: _build.launch_counts[k] - before[k] for k in before}
        print(f"  step {i} ({'warm-up' if i == 0 else 'timed'}) t={t}: "
              f"loss {float(loss):.6g} grad_norm {float(gnorm):.6g} fisher "
              f"{float(fisher):.6g} {ms:.1f} ms launches {json.dumps(delta)}")
        if delta != expected:
            failures.append(f"step {i} launches {delta} != {expected}")
        finite = all(bool(torch.isfinite(x).all())
                     for x in (loss, gnorm, fisher, grid))
        if not finite or not all(bool(torch.isfinite(p).all())
                                 for p in params.values()):
            failures.append(f"step {i}: non-finite output")
        if tuple(grid.shape) != (1, 3) + trainer.grid_hw:
            failures.append(f"step {i}: grid shape {tuple(grid.shape)}")
        losses.append(float(loss))
        if i:
            step_ms.append(ms)
    launches = {k: prep[k] + _build.launch_counts[k] for k in prep}
    changed = any(not torch.equal(init[k], params[k]) for k in init)
    if not changed:
        failures.append("params did not change")
    step_ms.sort()
    med = step_ms[len(step_ms) // 2]
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  SDS step median {med:.1f} ms "
          f"(timed {', '.join(f'{m:.1f}' for m in step_ms)}), peak memory "
          f"{mem:.2f} GiB, params changed: {changed} [{card_line()}]")

    # K6 and the routed attention calls on one more step, hooked; then the
    # plain GroupNorm path beside it
    with routed_attention_calls() as step_calls:
        k6 = groupnorm_traffic(torch, [trainer.teacher],
                               lambda: trainer.step(ts[-1]))
    err, single, two = check_routed_calls(torch, step_calls, "one SDS step",
                                          failures)
    del step_calls
    for key, n in (("flash_attn_single", single),
                   ("flash_attn_two_source", two)):
        recs[key].d["max_abs_err"] = max(recs[key].d["max_abs_err"], err)
        if n != expected[key]:
            failures.append(f"{key}: {n} routed calls in a step != "
                            f"{expected[key]}")
    gn.USE_KERNEL = False
    try:
        torch.cuda.synchronize()
        a = time.perf_counter()
        trainer.step(ts[-1])
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - a) * 1e3
        pl = groupnorm_traffic(torch, [trainer.teacher],
                               lambda: trainer.step(ts[-1]))
    finally:
        gn.USE_KERNEL = True
    print(f"  K6 on one step: {k6['calls']} GroupNorm calls, "
          f"{k6['bytes'] / 1e9:.3f} GB to move (x read once, y written "
          f"once), bound_ms {k6['bound_ms']:.3f} ({k6['bound_by']}); stream "
          f"time K6 {k6['stream_ms']:.2f} ms, plain {pl['stream_ms']:.2f} ms "
          f"(CUDA events around each call, launch gaps included)")
    print(f"  SDS step with USE_KERNEL=False (plain GroupNorm): "
          f"{plain_step_ms:.1f} ms, beside K6's median {med:.1f} ms")
    if k6["calls"] * gn.LAUNCHES_PER_CALL != expected["groupnorm"]:
        failures.append(f"K6 launches in a step "
                        f"{k6['calls'] * gn.LAUNCHES_PER_CALL} != "
                        f"{expected['groupnorm']}")
    ms, pms, lms, err, dms, ldms = groupnorm_signature_times(
        torch, k6["sigs"], failures, "step")
    print(f"  K6 at the step's {len(k6['sigs'])} shapes, timed alone and "
          f"summed over the step's calls: ms {ms:.3f} plain_ms {pms:.3f} "
          f"library_ms {lms:.3f} (F.group_norm, + F.silu where act: two "
          f"calls) bound_ms {k6['bound_ms']:.3f}; device time K6 "
          f"{dms:.3f} ms, library {ldms:.3f}; max_abs_err {err:.3e}")
    recs["groupnorm"].add(err, ms, pms, 12.0 * sum(
        n * a[0].numel() for n, a in k6["sigs"].values()), k6["bytes"],
        lib_ms=lms)
    if profile:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            trainer.step(ts[-1])
            torch.cuda.synchronize()
        table = p.key_averages().table(sort_by="cuda_time_total",
                                       row_limit=60)
        (out / "sds_step_profile.txt").write_text(table)
        print("  profile written to chiprun_out/sds_step_profile.txt")
    return launches, trainer


@contextlib.contextmanager
def plain_paths(torch, k5=True, k1=True):
    """Route the eval path's rasterizer (K5) and MLP queries (K1) through
    their plain PyTorch versions on the card, for the plain side of a
    comparison. The plain versions count no launches."""
    from contexture_nerf_tpu_torch.models import fields
    from contexture_nerf_tpu_torch.models import textured_mesh as tmm
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk
    from contexture_nerf_tpu_torch.raster import render as rnd
    from contexture_nerf_tpu_torch.raster.rasterize import \
        rasterize_geometry as raster_plain

    def plain_raster(fvz, fvi, h, w):
        return raster_plain(fvz, fvi, h, w, face_chunk=64)

    def plain_mlp(mlp, uv, multires=10, compute_dtype=torch.float32):
        params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
        ws, bs = mk.pack_params(params, multires)
        return mk.fused_nerf2d_plain(ws, bs, uv, multires, compute_dtype)

    swaps = []
    if k5:
        swaps += [(rnd, "rasterize_geometry", plain_raster),
                  (tmm, "rasterize_geometry", plain_raster)]
    if k1:
        swaps += [(tmm, "fused_nerf2d", plain_mlp),
                  (fields, "fused_nerf2d", plain_mlp)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def counted(torch, fn, want, label, launches, failures):
    """Run fn() with the launch counts set to 0 just before and read just
    after, timed on the host clock with the card synchronised; hold the
    counts to want(result) (the derived launches) and add them to
    `launches`. Returns (result, seconds)."""
    from contexture_nerf_tpu_torch.core import profiler
    from contexture_nerf_tpu_torch.ops import _build

    profiler.GLOBAL_TIMINGS = profiler.Timings()  # this run's timings
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, exp = dict(_build.launch_counts), want(out)
    ok = got == exp
    print(f"  {label}: launches {json.dumps(got)} "
          f"{'= derived' if ok else '!= derived ' + json.dumps(exp)}")
    if not ok:
        failures.append(f"{label} launches {got} != {exp}")
    for k in launches:
        launches[k] += got[k]
    return out, secs


def check_paint_outputs(torch, exp, seed, n_frames, failures):
    """What a finished paint run must have written, every value finite.
    Returns (metrics, timings)."""
    import numpy as np
    from PIL import Image, ImageSequence

    from contexture_nerf_tpu_torch.core.config import load_config

    bad = [n for n in ("config.yaml", "metrics.json", "timings.json",
                       "checkpoints/iter_000005", "checkpoints/iter_000010",
                       "results/eval_texture_atlas.png", "mesh/mesh.obj",
                       "mesh/mesh.mtl", "mesh/albedo.png")
           if not (exp / n).is_file()]
    vids = sorted((exp / "results").glob(
        f"eval_video_all_rendered_rgb_{seed}.*"))
    if not vids:
        bad.append("results/eval_video_all_rendered_rgb_*")
    if bad:
        failures.append(f"paint run: missing {bad}")
        return None, None
    metrics = json.loads((exp / "metrics.json").read_text())
    timings = json.loads((exp / "timings.json").read_text())
    keys = {"iter", "sds_loss", "grad_norm", "fisher_divergence_t",
            "ikl_running_avg", "t", "elapsed_s"}
    ok = [e["iter"] for e in metrics] == [0, 9] and all(
        set(e) == keys | {"view_consistency"} and all(
            math.isfinite(v) for v in e.values()) for e in metrics)
    win = timings.get("sds_step", {}).get("window_iter_ms")
    ok_t = win is not None and math.isfinite(win)
    frames = n_frames
    if vids[0].suffix == ".gif":  # equal neighbours merge: count the time
        with Image.open(vids[0]) as im:
            frames = sum(f.info["duration"]
                         for f in ImageSequence.Iterator(im)) // 40
    atlas = np.asarray(Image.open(exp / "results" / "eval_texture_atlas.png"))
    albedo = np.asarray(Image.open(exp / "mesh" / "albedo.png"))
    obj = (exp / "mesh" / "mesh.obj").read_text().splitlines()
    cfg_back = load_config([f"--config_path={exp / 'config.yaml'}"])
    print(f"  outputs: metrics at iterations {[e['iter'] for e in metrics]} "
          f"with keys {sorted(metrics[0])}, finite {ok}; sds_step "
          f"window_iter_ms {win}; turntable {vids[0].name} ({frames} "
          f"frames of 40 ms); atlas {atlas.shape}, albedo {albedo.shape}; mesh.obj "
          f"{len(obj)} lines; config.yaml loads back as "
          f"{cfg_back.log.exp_name}")
    if not ok:
        failures.append("paint run: metrics.json entries")
    if not ok_t:
        failures.append("paint run: timings.json has no sds_step window")
    if frames != n_frames or atlas.shape[-1] != 3 or albedo.shape[-1] != 3:
        failures.append("paint run: turntable or images malformed")
    return metrics, timings


def eval_shapes_vs_plain(torch, ct, atlas, recs, failures, card):
    """The default-size eval's new K5 and K1 shapes against the plain
    versions: two turntable frames (K5 bit for bit, and the frame through
    plain K5 bit for bit), the metric's views (K5 bit for bit, the metric
    within the bound K1's error gives), the UV-space raster (K5 bit for
    bit, the atlas through plain K5 bit for bit), K1 at the metric's UVs and
    on the texture lattice within mlp_tol."""
    from contexture_nerf_tpu_torch.models.fields import uv_lattice
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk
    from contexture_nerf_tpu_torch.raster import raster_kernel as rk
    from contexture_nerf_tpu_torch.raster.rasterize import rasterize_geometry
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg, mm, mlp = ct.cfg, ct.mesh_model, ct.mlp
    res = cfg.render.eval_grid_size
    texture = ct._eval_texture()
    poses = ct.dataloaders["val_large"].poses()
    k5_err = []  # max |bary - plain bary| of each new K5 shape
    for k in (0, len(poses) // 3):
        p = poses[k]
        pose = ([p["theta"]], [ct._adjust_phi(p["phi"])], [p["radius"]])
        _, fvc, fvi, _ = mm.project(*pose)
        fvz = fvc[..., 2].contiguous()
        idx, bary = rk.rasterize_geometry_kernel(fvz, fvi, res, res)
        p_idx, p_bary = rasterize_geometry(fvz, fvi, res, res)
        same = torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
        rgb = tr.eval_frame(mm, texture, *pose, res)
        with plain_paths(torch, k1=False):
            rgb_p = tr.eval_frame(mm, texture, *pose, res)
        frame_same = all(torch.equal(a, b) for a, b in zip(rgb, rgb_p))
        k5_err.append(float((bary - p_bary).abs().max()))
        label = f"K5 turntable frame {k} (1x{res}x{res}, F={fvz.shape[1]})"
        print(f"  {label}: bit-identical to plain {same}; the eval frame "
              f"(rgb, depth, z normals) through plain K5 bit-identical "
              f"{frame_same}")
        if not (same and frame_same):
            failures.append(label)
    ms, dev = raster_times(torch, rk.rasterize_geometry_kernel, fvz, fvi,
                           res, res)
    pms = cuda_ms(lambda: rasterize_geometry(fvz, fvi, res, res), reps=2,
                  warmup=1)
    pairs = pixel_face_pairs(torch, fvi, res, res)
    b_ms, by = bound(20.0 * pairs, res * res * 16 + fvz.shape[1] * 36,
                     H100_FP32_FLOPS)
    print(f"    K5 frame: {times_line(ms, dev)}; plain_ms {pms:.3f}; bound "
          f"{b_ms:.4f} ms ({by}) [{card}]")

    cache, _ = ct._consistency
    th, ph, r = tr.view_angles(cfg.render)
    _, fvc, fvi6, _ = mm.project(th[1:], ph[1:], r[1:])
    fvz6 = fvc[..., 2].contiguous()
    dims = cache.face_idx.shape[1]
    idx, bary = rk.rasterize_geometry_kernel(fvz6, fvi6, dims, dims)
    p_idx, p_bary = rasterize_geometry(fvz6, fvi6, dims, dims)
    same6 = torch.equal(idx, p_idx) and torch.equal(bary, p_bary) and \
        torch.equal(idx, cache.face_idx)
    k5_err.append(float((bary - p_bary).abs().max()))
    uv = cache.uv_features.reshape(-1, 2).contiguous()
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    wflat, bflat = mk.flatten_params(ws, bs, torch.bfloat16)

    def k1_check(name, pts):
        got = mk.mlp_fwd_kernel(wflat, bflat, pts, 10)
        ref = mk.fused_nerf2d_plain(ws, bs, pts, 10, torch.bfloat16)
        ref32 = mk.fused_nerf2d_plain(ws, bs, pts, 10, torch.float32)
        err = float((got - ref).abs().max())
        tol, noise = mlp_tol(ref, ref32)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"  K1 {name} ({pts.shape[0]} points): max_abs_err {err:.3e} "
              f"(tol {tol:.3e}, bf16-vs-f32 noise {noise:.3e}) "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"K1 {name}")
        recs["mlp_fwd"].d["max_abs_err"] = max(
            recs["mlp_fwd"].d["max_abs_err"], err)
        return err

    e6 = k1_check(f"at the metric's {cache.face_idx.shape[0]}x{dims}^2 UVs",
                  uv)
    k1_check("on the eval's texture lattice",
             uv_lattice(cfg.guide.texture_resolution, device="cuda"))
    vc = float(ct._view_consistency_metric())
    saved = ct._consistency
    ct._consistency = None
    with plain_paths(torch):
        vc_p = float(ct._view_consistency_metric())
    ct._consistency = saved
    # the geometry is the same; a pair's similarity moves by at most twice
    # the largest colour change, and |d colour| <= |d raw| / 2
    vc_tol = e6 + 1e-5
    print(f"  K5 metric views ({cache.face_idx.shape[0]}x{dims}x{dims}): "
          f"bit-identical to plain {same6}; metric {vc:.6f} vs plain "
          f"(plain K5 and K1) {vc_p:.6f}, |diff| {abs(vc - vc_p):.3e} "
          f"(bound {vc_tol:.3e} = 2 max|d colour| + 1e-5)")
    if not same6:
        failures.append("K5 metric views")
    if not abs(vc - vc_p) <= vc_tol:
        failures.append("view-consistency metric vs plain")

    tres = cfg.guide.texture_resolution
    fvi_uv = mm.face_attributes * 2.0 - 1.0
    fvz_uv = torch.ones(fvi_uv.shape[:-1], device=fvi_uv.device)
    idx, bary = rk.rasterize_geometry_kernel(fvz_uv, fvi_uv, tres, tres)
    p_idx, p_bary = rasterize_geometry(fvz_uv, fvi_uv, tres, tres)
    same_uv = torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
    k5_err.append(float((bary - p_bary).abs().max()))
    with plain_paths(torch, k1=False):
        atlas_k5p = mm.get_texture_map_only_valid_areas(mlp)
    atlas_same = torch.equal(atlas, atlas_k5p)
    print(f"  K5 UV-space raster (1x{tres}x{tres}, every z 1, "
          f"F={fvz_uv.shape[1]}): bit-identical to plain {same_uv}; "
          f"{float((idx >= 0).float().mean()):.4f} of texels covered; the "
          f"atlas through plain K5 bit-identical {atlas_same}")
    if not (same_uv and atlas_same):
        failures.append("K5 UV-space raster")
    recs["raster"].d["max_abs_err"] = max(recs["raster"].d["max_abs_err"],
                                          *k5_err)


def paint_path(torch, seed, trainer, recs, failures):
    """The CLI on spot_quick_test.yaml at full width (10 iterations,
    checkpoints every 5), its outputs; the run resumed from iteration 5
    against the uninterrupted one (final parameters and iteration 9's
    metrics at the reference's rtol 1e-6, atol 1e-7); then, on main_path's
    teacher and trained MLP (the SD2-depth stack, which main_path frees
    before its steps, is made anew: 0.4 s of random init), full_eval, the
    view-consistency metric and the
    UV-space atlas at the default config's sizes on the torus, each with
    its launches held to the derived counts, and their new K5 and K1
    shapes held to the plain versions (K5 bit for bit, K1 within mlp_tol).
    Returns the launches of these runs."""
    import gc
    import shutil

    from contexture_nerf_tpu_torch import run_contexture
    from contexture_nerf_tpu_torch.core import checkpoint as ckpt
    from contexture_nerf_tpu_torch.core import profiler
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    launches = {k: 0 for k in _build.launch_counts}
    exp_root = ROOT / "build" / "paint_path"
    shutil.rmtree(exp_root, ignore_errors=True)
    argv = [f"--config_path={ROOT / 'configs/text_guided/spot_quick_test.yaml'}",
            f"--guide.shape_path={ROOT / 'shapes' / 'sphere.obj'}",
            f"--log.exp_root={exp_root}", "--optim.checkpoint_interval=5",
            f"--optim.seed={seed}"]
    exp = exp_root / "spot_quick"
    torch.cuda.reset_peak_memory_stats()
    run, secs = counted(torch, lambda: run_contexture.main(argv),
                        lambda r: r.paint_kernel_launches(0),
                        "CLI paint run", launches, failures)
    n_frames = run.cfg.log.full_eval_size
    metrics, timings = check_paint_outputs(torch, exp, seed, n_frames,
                                           failures)
    first = {k: v.detach().clone() for k, v in run.mlp.state_dict().items()}
    finite = all(bool(torch.isfinite(v).all()) for v in first.values())
    if not finite:
        failures.append("paint run: non-finite parameters")
    if timings is not None:
        t = timings
        print(f"  CLI run {secs:.1f} s: sds_step window_iter_ms "
              f"{t['sds_step'].get('window_iter_ms')} over "
              f"{t['sds_step'].get('windows')} window(s) (dispatch "
              f"steady_mean_ms {t['sds_step']['steady_mean_ms']}), "
              f"view_consistency_metric first "
              f"{t['view_consistency_metric']['first_call_s']} s, "
              f"eval {t['eval']['total_s']} s for {n_frames} frames at "
              f"{run.cfg.render.eval_grid_size}^2 (window_iter_ms "
              f"{t['eval'].get('window_iter_ms')}), export "
              f"{t['export']['total_s']} s [{card}]")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the resume: iteration 10's checkpoint deleted, the run started again
    (exp / "checkpoints" / "iter_000010").unlink()
    run, secs = counted(
        torch, lambda: run_contexture.main(argv + ["--optim.resume=true"]),
        lambda r: r.paint_kernel_launches(5), "CLI resumed run", launches,
        failures)
    second = run.mlp.state_dict()
    resumed = json.loads((exp / "metrics.json").read_text())
    exact = all(torch.equal(first[k], second[k]) for k in first)
    close = all(torch.allclose(second[k], first[k], rtol=1e-6, atol=1e-7)
                for k in first)
    last_a = [e for e in (metrics or []) if e["iter"] == 9]
    last_b = [e for e in resumed if e["iter"] == 9]
    m_ok = bool(last_a) and bool(last_b) and all(
        math.isclose(last_b[0][k], last_a[0][k], rel_tol=1e-6, abs_tol=0.0)
        for k in ("sds_loss", "grad_norm", "fisher_divergence_t", "t",
                  "view_consistency"))
    m_exact = bool(last_a) and bool(last_b) and all(
        last_b[0][k] == last_a[0][k] for k in ("sds_loss", "grad_norm",
                                               "fisher_divergence_t", "t",
                                               "view_consistency"))
    print(f"  resumed from iteration 5 ({secs:.1f} s): final parameters "
          f"within rtol 1e-6 atol 1e-7 {close} (bit-identical {exact}); "
          f"iteration 9's metrics within rtol 1e-6 {m_ok} (bit-identical "
          f"{m_exact})")
    if not (close and m_ok):
        failures.append("resumed run differs from the uninterrupted one")
    if last_a and last_b and not m_exact:
        print(f"    iteration 9 uninterrupted {last_a[0]}\n"
              f"    iteration 9 resumed       {last_b[0]}")
    del run, second, first
    gc.collect()
    torch.cuda.empty_cache()
    paint_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the default config's eval sizes on the torus, on main_path's towers
    cfg = config_from_dict({"optim": {"seed": seed}, "guide": {
        "text": "a photo of a dairy cow",
        "shape_path": str(ROOT / "shapes" / "torus.obj")},
        "log": {"exp_root": str(exp_root), "exp_name": "torus_default"}})
    ct = tr.ConTEXTure(cfg, device="cuda", teacher=trainer.teacher,
                       mlp=trainer.mlp)
    ct._median_eval = True  # as after painting
    mm, mlp = ct.mesh_model, ct.mlp
    torch.cuda.reset_peak_memory_stats()

    one_each = {k: int(k in ("raster", "mlp_fwd")) for k in launches}
    vc, vc_s = counted(torch, lambda: float(ct._view_consistency_metric()),
                       lambda _: one_each,
                       "view-consistency metric (first call)", launches,
                       failures)
    vc_ms = cuda_ms(lambda: ct._view_consistency_metric(), reps=5)
    _, eval_s = counted(torch, ct.full_eval,
                        lambda _: tr.full_eval_kernel_launches(cfg),
                        f"full_eval ({cfg.log.full_eval_size} frames at "
                        f"{cfg.render.eval_grid_size}^2, texture "
                        f"{cfg.guide.texture_resolution}^2)", launches,
                        failures)
    summ = profiler.GLOBAL_TIMINGS.summary()
    atlas, _ = counted(torch, lambda: mm.get_texture_map_only_valid_areas(
        mlp), lambda _: one_each, "UV-space atlas", launches, failures)
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ct.save_checkpoint(1, trainer.optimizer)
    save_ms = (time.perf_counter() - t0) * 1e3
    path = ct.ckpt_path / "iter_000001"
    size = path.stat().st_size
    t0 = time.perf_counter()
    raw = ckpt.restore(path)
    mlp.load_state_dict(raw["params"])
    trainer.optimizer.load_state_dict(raw["opt_state"])
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        eval_shapes_vs_plain(torch, ct, atlas, recs, failures, card)
    res = cfg.render.eval_grid_size

    ev = summ.get("eval", {})
    print(f"  default-size eval: view-consistency metric {vc:.6f}, first "
          f"call {1e3 * vc_s:.1f} ms (geometry + query), then {vc_ms:.2f} ms "
          f"a call (query + metric) [{card}]")
    print(f"  default-size eval: full_eval {eval_s:.1f} s; eval "
          f"window_iter_ms {ev.get('window_iter_ms')} a frame over "
          f"{cfg.log.full_eval_size} frames at {res}^2 (the first frame "
          f"out of the window); eval phase {ev.get('total_s')} s with the "
          f"turntable file; export_mesh "
          f"{1e3 * summ.get('export', {}).get('total_s', float('nan')):.1f} "
          f"ms [{card}]")
    print(f"  checkpoint {size / 2 ** 20:.2f} MiB (MLP, Adam state, "
          f"generator, iteration): save {save_ms:.1f} ms, restore "
          f"{restore_ms:.1f} ms [{card}]")
    print(f"  paint path peak memory: CLI runs {paint_peak:.2f} GiB (with "
          f"main_path's teacher and MLP resident), default-size eval "
          f"{eval_peak:.2f} GiB [{card}]")
    print(f"  paint path {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K3/K4 at each query tile (BLOCK_M)")
    ap.add_argument("--mlp-only", action="store_true",
                    help="run only the K1/K2 kernel phases and stop (no "
                    "main path, no result line)")
    ap.add_argument("--raster-only", action="store_true",
                    help="run only the K5 phase and stop (no main path, no "
                    "result line)")
    ap.add_argument("--against", metavar="DIR",
                    help="with --raster-only: also time the K5 of the "
                    "checkout at DIR and of this one, in turns")
    ap.add_argument("--k5-times-of", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False; this needs a GPU")
    root = Path(args.k5_times_of).resolve() if args.k5_times_of else ROOT
    if not (root / "contexture_nerf_tpu_torch" / "csrc").is_dir():
        return fail("run from a checkout: contexture_nerf_tpu_torch/ "
                    f"is missing in {root}")
    sys.path.insert(0, str(root))
    if args.k5_times_of:
        raster_times_of(torch, root)
        return 0
    from contexture_nerf_tpu_torch.ops import _build

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, d in info.items():
        for line in d["log"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    failures = []
    recs = {
        "mlp_fwd": Record("mlp_fwd", "contexture_nerf_tpu_torch/csrc/mlp_fwd.cu",
                          "contexture_nerf_tpu/ops/mlp_kernel.py:81"),
        "mlp_bwd": Record("mlp_bwd", "contexture_nerf_tpu_torch/csrc/mlp_bwd.cu",
                          "contexture_nerf_tpu/ops/mlp_kernel.py:93"),
        "flash_attn_single": Record(
            "flash_attn_single", "contexture_nerf_tpu_torch/csrc/flash_attn.cu",
            "contexture_nerf_tpu/ops/attention.py:140"),
        "flash_attn_two_source": Record(
            "flash_attn_two_source",
            "contexture_nerf_tpu_torch/csrc/flash_attn.cu",
            "contexture_nerf_tpu/ops/attention.py:159"),
        "raster": Record("raster", "contexture_nerf_tpu_torch/csrc/raster.cu",
                         "contexture_nerf_tpu/raster/pallas_raster.py:41",
                         peak=H100_FP32_FLOPS),
        "groupnorm": Record("groupnorm",
                            "contexture_nerf_tpu_torch/csrc/groupnorm.cu",
                            "contexture_nerf_tpu/ops/groupnorm.py:69",
                            peak=H100_FP32_FLOPS),
    }
    from contexture_nerf_tpu_torch.core.config import config_from_dict

    if args.raster_only:
        print("K5 phase (kernel vs plain, f32):")
        raster_phases(torch, recs["raster"], config_from_dict({"guide": {
            "shape_path": str(ROOT / "shapes" / "torus.obj")}}), failures)
        if args.against:
            raster_against(Path(args.against).resolve(), failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    print("kernel phases (kernel vs plain, main-path shapes, bf16):")
    mlp_phases(torch, recs["mlp_fwd"], recs["mlp_bwd"], args.seed,
               960 * 640, 448 * 448, failures)
    if args.mlp_only:
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    attention_phases(torch, recs["flash_attn_single"],
                     recs["flash_attn_two_source"], args.seed, args.sweep,
                     failures)
    print("K5 phase (kernel vs plain, f32):")
    raster_phases(torch, recs["raster"], config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}}), failures)
    print("K6 phase (kernel vs plain, activation-like inputs):")
    groupnorm_phase(torch, args.seed, failures)
    print("main path: shapes/torus.obj -> prepare_sds (SD2-depth bootstrap) "
          "-> full-width SDS steps")
    launches, trainer = main_path(torch, args.seed, args.profile, recs,
                                  failures)
    print("paint path: the CLI on configs/text_guided/spot_quick_test.yaml "
          "(10 iterations, full-width towers), its resume, then full_eval, "
          "the view-consistency metric and the UV-space atlas at the "
          "default config's sizes on the torus")
    painted = paint_path(torch, args.seed, trainer, recs, failures)
    launches = {k: launches[k] + painted[k] for k in launches}
    del trainer
    for name, rec in recs.items():
        rec.d["launches"] = launches.get(name, 0)
        if rec.d["launches"] == 0:
            failures.append(f"{name} was not launched on the main path")
    if failures:
        for f in failures:
            print(f"FAIL: {f}")
        return 1
    print(json.dumps({"kernels": [r.out() for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
