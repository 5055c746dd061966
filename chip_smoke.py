#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (contexture_nerf_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--profile]

It builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version at the shapes the SDS step gives it (and checks that
two MLP-backward runs are bit-identical), then drives the full-width SDS
paint step (Zero123++ UNet + depth ControlNet + SD VAE encoder + the 8x256
texture MLP, a 960x640 canvas, bf16, random towers from the seed) for one
warm-up and three timed steps, checking that each kernel's launch count
rose by the count derived for one step. Any failed phase exits non-zero.
The last line is {"ok": true, "device": {...}}; the line before it is the
JSON record of the kernels. --profile also writes a torch.profiler table of
one step to chiprun_out/.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
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


def bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Record:
    """Per-kernel numbers summed over the launches of one SDS step."""

    def __init__(self, name, source, replaces):
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
        d["bound_ms"], d["bound_by"] = bound(d.pop("flops"), d.pop("bytes"))
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


def smoke_setup(seed, tile_px=320):
    """Stand-in for prepare_sds's output (until that slice is ported): the
    shapes it returns at full width, made from the seed with numpy. A smooth
    blob per tile for the mask, a blob-shaped depth, UVs in [0, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = 3 * tile_px, 2 * tile_px
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ty, tx = (yy % tile_px) / tile_px - 0.5, (xx % tile_px) / tile_px - 0.5
    r = np.sqrt(ty ** 2 + tx ** 2)
    radius = 0.3 + 0.1 * rng.random((3, 2)).astype(np.float32)
    rad = np.repeat(np.repeat(radius, tile_px, 0), tile_px, 1)
    mask = 1.0 / (1.0 + np.exp((r - rad) / 0.02))
    depth = mask * (1.0 - r / rad).clip(0, 1) + 0.5 * (1 - mask)
    return {
        "depth_grid": np.repeat(depth[None, None], 3, 1).astype(np.float32),
        "mask_grid": mask[None, None].astype(np.float32),
        "uv_grid_pts": rng.random((H * W, 2), dtype=np.float32),
        "cond_lat_pair": rng.standard_normal(
            (2, 4, tile_px // 8, tile_px // 8)).astype(np.float32),
        "encoder_hidden_states": rng.standard_normal(
            (2, 77, 1024)).astype(np.float32),
        "tile_probs": np.full(6, 1.0 / 6.0, np.float32),
    }


def main_path(torch, seed, profile, failures):
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.training.trainer import SDSTrainer

    t0 = time.perf_counter()
    cfg = config_from_dict({"optim": {"seed": seed}})
    trainer = SDSTrainer(cfg, smoke_setup(seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.teacher.parameters())
    print(f"  SDSTrainer built in {time.perf_counter() - t0:.1f} s: teacher "
          f"{n_params / 1e6:.1f} M params ({trainer.dtype}), canvas "
          f"{trainer.grid_hw}, backward slice {trainer.sl_h}x{trainer.sl_w}")
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
    launches = dict(_build.launch_counts)
    changed = any(not torch.equal(init[k], params[k]) for k in init)
    if not changed:
        failures.append("params did not change")
    step_ms.sort()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  SDS step median {step_ms[len(step_ms) // 2]:.1f} ms "
          f"(timed {', '.join(f'{m:.1f}' for m in step_ms)}), peak memory "
          f"{mem:.2f} GiB, params changed: {changed} [{card_line()}]")
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
    }
    print("kernel phases (kernel vs plain, main-path shapes, bf16):")
    mlp_phases(torch, recs["mlp_fwd"], recs["mlp_bwd"], args.seed,
               960 * 640, 448 * 448, failures)
    attention_phases(torch, recs["flash_attn_single"],
                     recs["flash_attn_two_source"], args.seed, failures)
    print("main path: full-width SDS step")
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
