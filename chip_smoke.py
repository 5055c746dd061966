#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (contexture_nerf_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--profile]

It builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version at the shapes the main path gives it (and checks that
two MLP-backward runs and two rasterizer runs are bit-identical, and that
planted faults miss the tolerances), then drives the main path at full
width from a mesh on disk: `build_sds_trainer` on shapes/torus.obj at the
default config (7 views of 1200x1200 rasterized, the 1024^2 texture, the
CLIP text and vision towers and the VAE conditioning of `prepare_sds`,
then the Zero123++ UNet + depth ControlNet + SD VAE encoder + 8x256 MLP on a
960x640 canvas, bf16, random towers from the seed) for one warm-up and
three timed SDS steps. prepare_sds's launches and each step's must equal
the counts derived for them. Any failed phase exits non-zero. The last line
is {"ok": true, "device": {...}}; the line before it is the JSON record of
the kernels. --profile also writes a torch.profiler table of one step to
chiprun_out/.
"""

import argparse
import json
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
    offset) instead of EMB_PAD:EMB_PAD+256."""
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

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


def attention_tol(ref):
    """Tolerance for flash attention held against its plain version: a
    tenth of the plain output's RMS. Both round P and the output to bf16 at
    other points, which measures one bf16 ulp of the largest outputs (about
    a twentieth of the RMS at these lengths); a dropped KV source or a wrong
    softmax scale moves the output by a sizeable part of its RMS."""
    return 0.1 * float(ref.float().pow(2).mean().sqrt())


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

    for label, n in (("canvas", n_canvas), ("slice", n_slice),
                     ("ragged", 1000)):  # ragged: not a multiple of 64
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
        ms = cuda_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, emb, None))
        pms = cuda_ms(lambda: mk.fused_nerf2d_plain(ws, bs, emb, None, bf),
                      reps=5)
        print(f"    ms {ms:.3f} plain_ms {pms:.3f}")
        rec_fwd.add(err, ms, pms, 2.0 * n * macs,
                    n * 48 * 2 + n * 3 * 4 + wbytes)

    # K2 on the slice, then on a ragged count
    for label, n in (("slice", n_slice), ("ragged", 1000)):
        uv = torch.rand((n, 2), generator=gen, device=dev)
        emb = mk.pad_embedding(uv, 10, dtype=bf)
        g = torch.randn((n, 3), generator=gen, device=dev) * 1e-2
        dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
        rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf)
        fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, f32)
        err = 0.0
        for i, (a, b, c) in enumerate(zip(dws + dbs, rws + rbs, fws + fbs)):
            err = max(err, check(f"K2 mlp_bwd {label} "
                                 f"{'dW' if i < 9 else 'db'}{i % 9} "
                                 f"{tuple(b.shape)}", a, b, c))
        if label == "ragged":
            continue
        dws2, dbs2 = mk.mlp_bwd_kernel(wflat, bflat, emb, g, None)
        same = all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))
        print(f"  K2 two runs bit-identical: {same}")
        if not same:
            failures.append("K2 determinism")
        check("K2 mlp_bwd uv dW0", mk.mlp_bwd_kernel(wflat, bflat, uv, g, 10)
              [0][0], rws[0], fws[0])
        for fault in ("relu6_mask", "skip_offset"):
            _, pws, pbs = planted_mlp(torch, ws, bs, emb, g, fault)
            caught(f"K2 {fault}", pws + pbs, rws + rbs, fws + fbs)
        ms = cuda_ms(lambda: mk.mlp_bwd_kernel(wflat, bflat, emb, g, None))
        pms = cuda_ms(
            lambda: mk.fused_nerf2d_bwd_plain(ws, bs, emb, g, None, bf),
            reps=5)
        print(f"    ms {ms:.3f} plain_ms {pms:.3f}")
        rec_bwd.add(err, ms, pms, 2.0 * n * (3 * macs - 42 * 256),
                    n * 48 * 2 + n * 3 * 4 + wbytes
                    + (wflat.numel() + bflat.numel()) * 4)

    # K1 on the texture lattice that prepare_sds queries once (uv in); its
    # time is printed here and kept out of the per-step record
    from contexture_nerf_tpu_torch.models.fields import uv_lattice

    uv = uv_lattice(1024, device=dev)
    err = check(f"K1 mlp_fwd uv lattice ({uv.shape[0]}, 2)",
                mk.mlp_fwd_kernel(wflat, bflat, uv, 10),
                mk.fused_nerf2d_plain(ws, bs, uv, 10, bf),
                mk.fused_nerf2d_plain(ws, bs, uv, 10, f32))
    rec_fwd.d["max_abs_err"] = max(rec_fwd.d["max_abs_err"], err)
    ms = cuda_ms(lambda: mk.mlp_fwd_kernel(wflat, bflat, uv, 10))
    pms = cuda_ms(lambda: mk.fused_nerf2d_plain(ws, bs, uv, 10, bf), reps=3)
    b_ms, b_by = bound(2.0 * uv.shape[0] * macs,
                       uv.shape[0] * (2 * 4 + 3 * 4) + wbytes)
    print(f"    ms {ms:.3f} plain_ms {pms:.3f} bound_ms {b_ms:.3f} ({b_by}); "
          "once per prepare_sds")


def attention_phases(torch, rec1, rec2, seed, failures):
    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    # (B, H, Sq, Skv, Se, launches per step) at the main path's routed shapes
    shapes = [(2, 5, 1600, 1600, 0, 5), (2, 5, 9600, 9600, 0, 2),
              (2, 10, 2400, 2400, 0, 2),
              (2, 5, 9600, 9600, 1600, 5), (2, 10, 2400, 2400, 400, 5),
              (1, 3, 777, 1234, 0, 0), (1, 3, 777, 1234, 301, 0)]
    for B, H, sq, skv, se, times in shapes:
        def rnd(s):
            return torch.randn((B, H, s, 64), generator=gen, device=dev,
                               dtype=torch.bfloat16)
        q, k, v = rnd(sq), rnd(skv), rnd(skv)
        ek, ev = (rnd(se), rnd(se)) if se else (None, None)
        got = att.flash_attention(q, k, v, ek, ev)
        ref = att.flash_attention_plain(q, k, v, ek, ev)
        err = float((got.float() - ref.float()).abs().max())
        tol = attention_tol(ref)
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        name = f"K{4 if se else 3} flash ({B},{H},{sq},{skv}+{se})"
        print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = 0.1 "
              f"RMS(plain)) {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(name)
        # planted faults, through the kernel itself: the TPU's padded width
        # in the softmax scale (1/sqrt(128) for 1/sqrt(64)), and the second
        # KV source dropped
        faults = {"scale 1/sqrt(128)": att.flash_attention(
            (q.float() * 0.5 ** 0.5).to(q.dtype), k, v, ek, ev)}
        if se:
            faults["second source dropped"] = att.flash_attention(q, k, v)
        for fname, bad in faults.items():
            ratio = float((bad.float() - ref.float()).abs().max()) / tol
            print(f"    planted fault {fname}: max err/tol {ratio:.2f} "
                  f"{'caught' if ratio > 1 else 'NOT CAUGHT'}")
            if not ratio > 1:
                failures.append(f"{name}: tolerance passes {fname}")
        ms = cuda_ms(lambda: att.flash_attention(q, k, v, ek, ev))
        pms = cuda_ms(lambda: att.flash_attention_plain(q, k, v, ek, ev),
                      reps=3, warmup=1)
        kc = torch.cat([k, ek], 2) if se else k
        vc = torch.cat([v, ev], 2) if se else v
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kc, vc))
        print(f"    ms {ms:.3f} plain_ms {pms:.3f} library_ms {lms:.3f}")
        nkv = skv + se
        flops = 4.0 * B * H * sq * nkv * 64
        nbytes = 2 * B * H * 64 * (2 * sq + 2 * nkv)
        rec = rec2 if se else rec1
        if times:
            rec.add(err, ms, pms, flops, nbytes, times, lms)
        else:
            rec.add(err, 0.0, 0.0, 0.0, 0.0, 0)


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


def raster_phases(torch, rec, cfg, failures):
    """K5 against its plain version: the torus's 7 views at 1200^2 (the
    main path's launch), a 50,880-face sphere on one 1200^2 view, and the
    torus at a ragged 777 x 1234. Planted faults run through the plain
    version on the torus."""
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel
    from contexture_nerf_tpu_torch.raster import raster_kernel as rk
    from contexture_nerf_tpu_torch.raster.rasterize import rasterize_geometry
    from contexture_nerf_tpu_torch.training.trainer import view_angles

    dev = torch.device("cuda")
    res = cfg.render.train_grid_size
    mm = TexturedMeshModel(cfg.guide, render_grid_size=res, device=dev)
    th, ph, r = view_angles(cfg.render)
    _, fvc, torus_fvi, _ = mm.project(th, ph, r)
    torus_z = fvc[..., 2].contiguous()
    v, f = numpy_uv_sphere(160, 160)
    v = torch.from_numpy(v * 0.6).to(dev)
    v[:, 1] += 0.25
    _, fvc, sphere_fvi, _ = mm.renderer.project(
        v, torch.from_numpy(f).to(dev), th[:1], ph[:1], r[:1], 0.25)
    cases = [("torus 7 views", torus_z, torus_fvi, res, res),
             (f"sphere {f.shape[0]} faces", fvc[..., 2].contiguous(),
              sphere_fvi, res, res),
             ("torus 2 views ragged", torus_z[:2], torus_fvi[:2], 777, 1234)]
    for name, fvz, fvi, H, W in cases:
        idx, bary = rk.rasterize_geometry_kernel(fvz, fvi, H, W)
        idx2, bary2 = rk.rasterize_geometry_kernel(fvz, fvi, H, W)
        p_idx, p_bary = rasterize_geometry(fvz, fvi, H, W)
        a = rk.raster_agreement(idx, bary, p_idx, p_bary, fvz)
        same = torch.equal(idx, idx2) and torch.equal(bary, bary2)
        ok = rk.agreement_ok(a) and same
        label = f"K5 raster {name} ({fvz.shape[0]}x{H}x{W}, " \
                f"F={fvz.shape[1]})"
        print(f"  {label}: face_idx agree {a['agree']:.6f} on {a['covered']} "
              f"covered px, {a['mismatch']} mismatched ({a['unexplained']} "
              f"neither a z tie <= 1e-6 nor an edge <= 1e-5), bary max err "
              f"{a['bary_err']:.3e} (tol 1e-5), two runs bit-identical "
              f"{same} {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(label)
        if name != "torus 7 views":
            rec.add(a["bary_err"], 0.0, 0.0, 0.0, 0.0, times=0)
            continue
        for fault, (fz, fi) in {
                "z test reversed (farthest face wins)": (-fvz, fvi),
                "last 64-face chunk dropped": (fvz[:, :-64], fvi[:, :-64]),
        }.items():
            b = rk.raster_agreement(*rasterize_geometry(fz, fi, H, W),
                                    p_idx, p_bary, fvz)
            caught = not rk.agreement_ok(b)
            print(f"    planted fault {fault}: agree {b['agree']:.6f}, "
                  f"{b['unexplained']} unexplained "
                  f"{'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                failures.append(f"K5 limits pass planted fault {fault}")
        ms = cuda_ms(lambda: rk.rasterize_geometry_kernel(fvz, fvi, H, W))
        pms = cuda_ms(lambda: rasterize_geometry(fvz, fvi, H, W), reps=2,
                      warmup=1)
        pairs = pixel_face_pairs(torch, fvi, H, W)
        B, F = fvz.shape[:2]
        nbytes = B * H * W * 16 + B * F * (16 + 64) + (H + W) * 4
        print(f"    ms {ms:.3f} (face setup + launch) plain_ms {pms:.3f}; "
              f"{pairs:.4g} (pixel, face) pairs in a face box, "
              f"{pairs / (B * H * W):.2f} a pixel")
        rec.add(a["bary_err"], ms, pms, 20.0 * pairs, nbytes)


def prepare_sds_launches():
    """Kernel launches of prepare_sds on the card: K5 once for the 7 views,
    K1 once for the texture lattice; nothing else launches a kernel there
    (CLIP's 257 and 77 tokens route to the plain attention path)."""
    from contexture_nerf_tpu_torch.ops import _build

    return {k: {"raster": 1, "mlp_fwd": 1}.get(k, 0)
            for k in _build.launch_counts}


def check_setup(torch, setup, trainer, failures):
    """prepare_sds's outputs: the shapes at full width, finite values, an
    object on the canvas, UVs in [0, 1], probabilities that sum to 1."""
    t = trainer.tile_px
    shapes = {"depth_grid": (1, 3, 3 * t, 2 * t),
              "mask_grid": (1, 1, 3 * t, 2 * t),
              "uv_grid_pts": (6 * t * t, 2), "cond_image": (1, 3, t, t),
              "cond_lat_pair": (2, 4, t // 8, t // 8),
              "encoder_hidden_states": (2, 77, 1024), "tile_probs": (6,)}
    for k, shape in shapes.items():
        x = setup[k]
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            failures.append(f"prepare_sds {k}: shape {tuple(x.shape)} "
                            f"(want {shape}) or non-finite")
    m = setup["mask_grid"]
    uv = setup["uv_grid_pts"]
    ok = (float(m.max()) > 0.99 and float(m.min()) < 0.01
          and float(uv.min()) >= 0 and float(uv.max()) <= 1
          and abs(float(setup["tile_probs"].sum()) - 1) < 1e-5
          and len(setup["bboxes6"]) == 6)
    print(f"  setup: mask_grid mean {float(m.mean()):.4f}, cond_image mean "
          f"{float(setup['cond_image'].mean()):.4f}, depth_grid mean "
          f"{float(setup['depth_grid'].mean()):.4f}, tile_probs "
          f"{[round(float(p), 4) for p in setup['tile_probs']]}, bboxes6 "
          f"{setup['bboxes6']} {'ok' if ok else 'BAD'}")
    if not ok:
        failures.append("prepare_sds outputs out of range")


def groupnorm_traffic(torch, trainer, run_step):
    """The GroupNorm(+SiLU) calls of one SDS step, where K6 (the TPU's
    fused GroupNorm kernel, not yet ported) would run: their count, the
    bytes a two-phase kernel must move (read x twice, write y once), the
    least time the card could take for them (bytes; their ~10 FP32
    operations an element need less) and the plain path's device time,
    from CUDA events around each call."""
    from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

    calls = []

    def pre(mod, inp):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append([inp[0], ev])

    def post(mod, inp, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        x = calls[-1][0]
        calls[-1] = (x.numel(), 2 * x.numel() * x.element_size()
                     + out.numel() * out.element_size(), calls[-1][1], ev)

    mods = [m for m in trainer.teacher.modules()
            if isinstance(m, GroupNormSiLU)]
    hooks = [h for m in mods for h in (m.register_forward_pre_hook(pre),
                                       m.register_forward_hook(post))]
    try:
        run_step()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    elems = sum(c[0] for c in calls)
    nbytes = sum(c[1] for c in calls)
    plain_ms = sum(c[2].elapsed_time(c[3]) for c in calls)
    b_ms, b_by = bound(10.0 * elems, nbytes, H100_FP32_FLOPS)
    return {"calls": len(calls), "bytes": nbytes, "bound_ms": b_ms,
            "bound_by": b_by, "plain_ms": plain_ms}


def main_path(torch, seed, profile, failures):
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.training.trainer import build_sds_trainer

    cfg = config_from_dict({"optim": {"seed": seed}, "guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, setup = build_sds_trainer(cfg, device="cuda", timings=timings)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    prep = dict(_build.launch_counts)
    n_params = sum(p.numel() for p in trainer.teacher.parameters())
    n_clip = sum(p.numel() for m in (trainer.teacher.text_encoder,
                                     trainer.teacher.vision_encoder)
                 for p in m.parameters())
    prep_ms = sum(timings.values())
    print(f"  build_sds_trainer (teacher init + prepare_sds + trainer) "
          f"{built_s:.1f} s: teacher {n_params / 1e6:.1f} M params "
          f"({n_clip / 1e6:.1f} M of them CLIP) in {trainer.dtype}, canvas "
          f"{trainer.grid_hw}, backward slice {trainer.sl_h}x{trainer.sl_w}")
    print(f"  prepare_sds {prep_ms:.1f} ms: " + ", ".join(
        f"{k} {v:.1f}" for k, v in timings.items()) + " ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{json.dumps(prep)}")
    if prep != prepare_sds_launches():
        failures.append(f"prepare_sds launches {prep} != "
                        f"{prepare_sds_launches()}")
    check_setup(torch, setup, trainer, failures)
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
        params, loss, gn, fisher, grid = trainer.step(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - a) * 1e3
        delta = {k: _build.launch_counts[k] - before[k] for k in before}
        print(f"  step {i} ({'warm-up' if i == 0 else 'timed'}) t={t}: "
              f"loss {float(loss):.6g} grad_norm {float(gn):.6g} fisher "
              f"{float(fisher):.6g} {ms:.1f} ms launches {json.dumps(delta)}")
        if delta != expected:
            failures.append(f"step {i} launches {delta} != {expected}")
        finite = all(bool(torch.isfinite(x).all())
                     for x in (loss, gn, fisher, grid))
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
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  SDS step median {step_ms[len(step_ms) // 2]:.1f} ms "
          f"(timed {', '.join(f'{m:.1f}' for m in step_ms)}), peak memory "
          f"{mem:.2f} GiB, params changed: {changed} [{card_line()}]")
    k6 = groupnorm_traffic(torch, trainer, lambda: trainer.step(ts[-1]))
    print(f"  K6 (not ported) on one more step: {k6['calls']} GroupNorm "
          f"calls, {k6['bytes'] / 1e9:.3f} GB to move (x read twice, y "
          f"written once), bound_ms {k6['bound_ms']:.3f} ({k6['bound_by']}), "
          f"plain path {k6['plain_ms']:.2f} ms of device time")
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
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False; this needs a GPU")
    if not (ROOT / "contexture_nerf_tpu_torch" / "csrc").is_dir():
        return fail("run from a checkout: contexture_nerf_tpu_torch/ "
                    "is missing")
    sys.path.insert(0, str(ROOT))
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
    }
    from contexture_nerf_tpu_torch.core.config import config_from_dict

    print("kernel phases (kernel vs plain, main-path shapes, bf16):")
    mlp_phases(torch, recs["mlp_fwd"], recs["mlp_bwd"], args.seed,
               960 * 640, 448 * 448, failures)
    attention_phases(torch, recs["flash_attn_single"],
                     recs["flash_attn_two_source"], args.seed, failures)
    print("K5 phase (kernel vs plain, f32):")
    raster_phases(torch, recs["raster"], config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}}), failures)
    print("main path: shapes/torus.obj -> prepare_sds -> full-width SDS "
          "steps")
    launches = main_path(torch, args.seed, args.profile, failures)
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
