#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (contexture_nerf_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--profile] [--sweep]
                          [--mlp-only | --raster-only [--against DIR] |
                           --snapshot-only | --mesh-only | --generate-only |
                           --int8-only | --tools-only | --parallel-only |
                           --sv3d-only | --flux-only | --k7-only]

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
towers from the seed) for one warm-up and three timed SDS steps (the
teacher's call eager in the first, captured as CUDA graphs in the second,
replayed after: diffusion/teacher_graph.py; its counters and the bytes
its graphs keep are printed), then one step with the graphs dropped and
the GroupNorms and the attention layers hooked (K6's calls, bytes and
per-shape times; K3/K4 held to their limit on every kernel-routed call,
as on one bootstrap UNet call); `teacher_v_pred` at the step's inputs must
equal the step's own teacher call bit for bit (a planted guidance scale of
1 must not). Every run's K3, K4, K6 and gn_bwd launches are held to the
census of the calls it routes to them (`tools/launches.py` in the port;
a replay runs those calls eagerly between its graphs, so they are
launched and counted as without graphs); the other kernels' launches are
printed as counted. Two planted routing faults (one GroupNorm call on the
plain version, one kernel-routed attention call on the plain route), each
in a replayed teacher call, must fail that check. Then the paint
path (the CLI on spot_quick_test.yaml, its resume, the default-size eval)
and the snapshot path: the paint path's first CLI run
again from its seeded towers written to disk as diffusers snapshots (17.6 GB
at F32 under build/snapshots/, deleted after), which must equal the
random-tower run bit for bit. Then the mesh path (`mesh_path`): a
100,000-face sphere written without UVs, its atlas unwrapped on the host
and cached, K5 on it and on its atlas, K1 and K2 at the fit's 4,096 and
the texture lattice's 1,048,576 points, the 300-step fit to an image,
exact_lattice_render steps (two runs from one state), the
reference_texture mask on the default path, the kaolin-compatible
`rasterize` (K5) and `render_multiple_view_texture` against their plain
and composed versions bit for bit, and the sphere as an OFF through the
CLI beside its OBJ (2 SDS iterations each, bit for bit), on main_path's
teacher. Then
the generation path (`generation_path`): get_depth_maps_cond_grid on the
torus (7 views, the SD2-depth paint of the front view) and a repaint
(paint step 2: median fill, inpaint UNet), check_gt_zero123plus on its two
PNGs (28 EulerAncestral steps of the Zero123++ UNet, ControlNet and
reference attention at 960x640, the 960x640 decode), generate again from
the same draws (bit-identical), with blending and inpainting, and at
masks 1 and 0 (the plain grid and the decode of the renders, bit for
bit); K3/K4 and K6 held to their limits on a generate step, an inpaint
step on the canvas, a repaint inpaint step and the decode. The int8 path
(`int8_path`, after the main path, on its trainer): the W8A8 teacher's
largest quantized Dense and conv calls on the card against the CPU (q,
scales and int32 sums bit for bit, outputs within one bf16 ulp; three
planted faults), their parts' times beside the bf16 library ops, and SDS
steps in bf16, int8_controlnet and int8_teacher in turns. The tools path
(`tools_path`, after the generation path): the semantic smoke (200 steps,
err_after within 0.15; a green-target teacher must fail it), one run_one
of each root driver on the torus with the main path's towers,
render_face_normals_face_idx against the plain rasterizer and the CPU,
and volume_render at bench.py's shape against the CPU, compare_outputs on
two runs' outputs and knob_quality's two paints. The parallel path
(`parallel_path`, last): one NCCL rank per visible GPU (up to 4; world
size 1 on a one-GPU machine, which exercises no multi-rank collective),
the sharded SDS step against the single-device step, ring attention at
the teacher's shape, a TP teacher call and the sharded eval. The mesh
path also times the C++ unwrap and OBJ reader against the numpy ones. Any
failed phase exits non-zero. The last line is {"ok": true,
"device": {...}}; the line before it is the JSON record of the kernels.
--profile also writes a torch.profiler table of one step to chiprun_out/;
--sweep also times K3/K4 at each query tile the kernel is built for.
--mlp-only runs only the K1/K2 phases, --raster-only only the K5 phase (no
main path, no result line); --against DIR then also times the K5 of the
checkout at DIR (an earlier commit unpacked there) and of this one, in
turns, each in a subprocess on the same card. --snapshot-only runs only the
snapshot path, with its own random-tower run to hold the loaded run to (no
result line). --mesh-only runs only the mesh path, on a teacher of its
own (no result line). --generate-only runs only the generation path, on
towers of its own (no result line). --int8-only runs only the int8 path,
on a trainer of its own without the bootstrap; --tools-only only the
tools path, on towers of its own (no result line). --parallel-only runs
only the parallel path (no result line). --sv3d-only runs only SV3D_p's
kernel shapes (K3 at 42 frames x 5 heads of 5,184 tokens and at level 1,
K6 forward on the frame-stacked layout, gn_bwd at the 576^2 frame encode)
and its paint loop at full width (a step's launches, spans and host reads,
its time), then prints those shapes' records, with a step's launches, as
its `kernels` line; the full script runs both and adds the records to its
own `kernels` line. --flux-only does the same for FLUX.1 Depth (K3 at head
dim 128 at its joint attention of 24 heads over 2,912 tokens, with v read
through the fused linear's strides, and at a ragged shape; a full-width
step: its launches held to the census, K3's 57 at d = 128 among them, its
flux.double / flux.single spans and host reads, the teacher's counters, its
time). --k7-only runs only the K7 phase (`texture_phase`: the
masked texture sample and its backward at the exact path's 6 x 1200^2
views and 1024^2 texture, bilinear and nearest, and at a ragged shape,
against their plain versions, timed beside their bounds, the plain path's
forward and backward and the plan's build) and prints its records; the
full script runs it after the K6 backward phase, and its records carry the
mesh path's exact steps' launches and a step's.
"""

import argparse
import contextlib
import gc
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


class NotMeasured(float):
    """A device reading the profiler left empty: NaN that prints as "not
    measured (N events seen)" and stays so through the sums, products and
    quotients it enters (their events added), so a sum with one empty
    reading in it is not measured either."""

    def __new__(cls, events):
        self = super().__new__(cls, math.nan)
        self.events = events
        return self

    def _join(self, other):
        return NotMeasured(self.events + getattr(other, "events", 0))

    __add__ = __radd__ = __sub__ = __rsub__ = _join
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _join

    def __format__(self, spec):
        return f"not measured ({self.events} events seen)"

    def __str__(self):
        return format(self)

    __repr__ = __str__


# the windows device_ms_by_kernel took, those that came back without
# device time by their try (0: a reading's first window) and the events
# those held; printed at the end of the script
PROFILER_WINDOWS = {"taken": 0, "empty by try": {}, "events in empty": 0}


def device_ms_by_kernel(fn, reps=20, tries=4, pad_s=0.01):
    """{kernel name: milliseconds of device time a call of fn() spends in
    it}: the profiler's self device time over reps calls, after a warm-up.
    Windows of a few short calls have come back without device events, so
    each window is padded with pad_s of idle host time before the first
    call and after the synchronise that ends the last, and a window that
    still comes back empty is taken again with twice the reps and the
    padding, up to `tries` times. A reading that stays empty is {"not
    measured": NotMeasured(the events the last window held)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        PROFILER_WINDOWS["taken"] += 1
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as p:
            time.sleep(pad_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        times = {e.key: e.self_device_time_total / reps / 1e3
                 for e in p.key_averages() if e.self_device_time_total > 0}
        if times:
            return times
        empty = PROFILER_WINDOWS["empty by try"]
        empty[i] = empty.get(i, 0) + 1
        PROFILER_WINDOWS["events in empty"] += len(p.events())
        reps, pad_s = 2 * reps, 2 * pad_s
    return {"not measured": NotMeasured(len(p.events()))}


def device_ms(fn, reps=20, tries=4):
    """Milliseconds of device time a call of fn() spends in kernels: the
    card's own time, without the host work between launches that cuda_ms
    also counts where a call is shorter than its host work. A NotMeasured,
    never 0, when the profiler saw no device events."""
    return sum(device_ms_by_kernel(fn, reps, tries).values())


def share_of_bound(bound_ms, dev_ms):
    """A device time's share of its bound ("at K% of the bound"), or what
    NotMeasured prints."""
    return (f"{dev_ms}" if isinstance(dev_ms, NotMeasured)
            else f"at {100 * bound_ms / dev_ms:.0f}% of the bound")


def bound(flops, nbytes, peak=H100_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Record:
    """Per-kernel numbers summed over the launches of one run of the main
    path's stage that launches it (one SDS step, or prepare_sds); `peak` is
    the card's operation rate for the kernel's arithmetic. A shape record
    whose launches are several launch-shape keys' lists them as `keys`."""

    def __init__(self, name, source, replaces, peak=H100_BF16_FLOPS,
                 keys=None):
        self.peak, self.keys = peak, keys
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


def rel_fro(a, b):
    """||a - b|| / ||b||, Frobenius norms (0 where a equals b)."""
    d = float((a.float() - b.float()).norm())
    return d / float(b.float().norm()) if d else 0.0


def fro_tol(ref, ref32):
    """(tolerance, noise) of an MLP kernel output's relative Frobenius
    error against its plain bf16 version `ref` (see mlp_check)."""
    noise = rel_fro(ref32, ref)
    return max(0.5 * noise, 1e-5), noise


def mlp_check(name, got, ref, ref32, failures):
    """An MLP kernel's output held against its plain bf16 version `ref`
    twice. (1) Its max abs error at the bf16 noise level: both round every
    matmul operand to bf16 at the same points and sum in f32 in other
    orders, so a sum next to a rounding boundary flips one ulp and the flip
    cascades through the later layers. The plain bf16 version's distance
    from plain f32 (`ref32`) measures that noise; the kernel must stay
    within twice it (or 1e-3 of max|plain| where bf16 is exact). (2) Its
    relative Frobenius error within half the plain bf16 version's from
    plain f32 (or 1e-5 where bf16 is exact): rounding at the same points,
    the kernel sits far nearer the plain bf16 version than plain f32 does
    (on an H100, K2 at 4,096 and 1,048,576 points 4e-3-1e-2 from it, plain
    f32 0.045-0.15), while a kernel that drops work or rounds elsewhere
    lands at the bf16-vs-f32 distance or beyond: a point chunk missing from
    K2's dW sum (1/32 of 4,096 points) does, and (1), whose largest entry
    can hide it, may pass it. The planted faults show that a wrong kernel
    misses one of the two. Returns the max abs error."""
    import torch

    err = float((got - ref).abs().max())
    tol, noise = mlp_tol(ref, ref32)
    rel = rel_fro(got, ref)
    rtol, rnoise = fro_tol(ref, ref32)
    ok = err <= tol and rel <= rtol and bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = max(2 x "
          f"bf16-vs-f32 {noise:.3e}, 1e-3 max|plain|); max|plain| "
          f"{float(ref.abs().max()):.3e}); rel. Frobenius err {rel:.3e} "
          f"(tol {rtol:.3e} = max(bf16-vs-f32 {rnoise:.3e} / 2, 1e-5)) "
          f"{'ok' if ok else 'MISS'}")
    if not ok:
        failures.append(name)
    return err


def mlp_caught(name, got, refs, refs32, failures):
    """A planted fault must miss one of mlp_check's two limits on at least
    one tensor."""
    r_abs = max(float((a - b).abs().max()) / mlp_tol(b, c)[0]
                for a, b, c in zip(got, refs, refs32))
    r_fro = max(rel_fro(a, b) / fro_tol(b, c)[0]
                for a, b, c in zip(got, refs, refs32))
    caught = r_abs > 1 or r_fro > 1
    print(f"  planted fault {name}: max err/tol {r_abs:.2f}, rel. Frobenius "
          f"err/tol {r_fro:.2f} {'caught' if caught else 'NOT CAUGHT'}")
    if not caught:
        failures.append(f"tolerance passes planted fault {name}")


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


def mlp_bwd_breakdown(torch, mk, wflat, bflat, wt, x, g, multires):
    """K2's device time by kernel (TFLOP/s where its operations are
    counted), the bytes of its buffers and the card's peak memory in a
    call."""
    n = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = mk.dw_plan(n, sms)
    hidden = 2.0 * n * mk.W * sum(mk.LAYER_K[:mk.DEPTH])
    flops = {"mlp_fwd_kernel<1>": ("the recompute", hidden),
             "mlp_fwd_kernel<2>": ("the delta loop",
                                   2.0 * n * mk.W * mk.DELTA_ROWS),
             "mlp_bwd_dw_kernel": ("dW_0..dW_7", hidden)}

    def k2():
        return mk.mlp_bwd_kernel(wflat, bflat, x, g, multires, wt)

    for name, t in sorted(device_ms_by_kernel(k2).items(),
                          key=lambda kv: -kv[1]):
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
    k2()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    busy = min(plan["chunks"], -(-plan["ksteps"] // plan["steps"]))
    print(f"      buffers: act + delta {buffers / 1e9:.3f} GB, partials "
          f"{partials / 1e6:.1f} MB ({plan['chunks']} chunks of "
          f"{plan['steps']} k-steps over {plan['ksteps']}: {busy} with "
          f"points, {plan['chunks'] - busy} empty; grid {plan['grid']} = "
          f"{plan['grid'] / sms:.2f} waves of {sms}); peak "
          f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above "
          "the inputs)")


HELD = "held"  # an mlp_phases record: held to the plain version, not timed


def mlp_phases(torch, seed, shapes, failures):
    """K1 and K2 held to their plain versions (mlp_check) at each of
    `shapes`: (label, points, input, K1's record, K2's record). The input
    "emb" is the padded bf16 embedding the SDS step passes, "uv" random uv
    points and "lattice" the uv of the 1024^2 texture lattice (both
    embedded in the kernel, multires 10). A record None: the kernel does
    not run at that shape; HELD: held to the plain version only. Otherwise
    the planted faults must miss the limits, two runs must be
    bit-identical, and the times go into the record."""
    from contexture_nerf_tpu_torch.models.fields import NeRF2D, uv_lattice
    from contexture_nerf_tpu_torch.ops import mlp_kernel as mk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    mlp = NeRF2D(generator=gen, device=dev).requires_grad_(False)
    params = [p for lin in mlp.linears() for p in (lin.weight, lin.bias)]
    ws, bs = mk.pack_params(params, 10)
    bf, f32 = torch.bfloat16, torch.float32
    wflat, bflat = mk.flatten_params(ws, bs, bf)
    wt = mk.transposed_stack(wflat)  # K2's delta weights, packed once
    macs = sum(l.in_features * l.out_features for l in mlp.linears())
    wbytes = wflat.numel() * 2 + bflat.numel() * 4
    card = card_line()
    device_total = {}

    def timed(rec, label, err, kernel, plain, flops, nbytes):
        ms = cuda_ms(kernel)
        dms = device_ms(kernel, reps=10)
        pms = (cuda_ms(plain, reps=3, warmup=1) if label == "lattice"
               else cuda_ms(plain, reps=5))
        b_ms, b_by = bound(flops, nbytes)
        print(f"    {rec.d['name']}: ms {ms:.3f} (device time {dms:.3f}, "
              f"{flops / dms / 1e9:.0f} TFLOP/s) plain_ms {pms:.3f} bound_ms "
              f"{b_ms:.4f} ({b_by}) [{card}]")
        rec.add(err, ms, pms, flops, nbytes)
        device_total[rec.d["name"]] = device_total.get(
            rec.d["name"], []) + [(label, dms)]

    for label, n, kind, rec1, rec2 in shapes:
        uv = (uv_lattice(1024, device=dev) if kind == "lattice"
              else torch.rand((n, 2), generator=gen, device=dev))
        x, mr = ((mk.pad_embedding(uv, 10, dtype=bf), None) if kind == "emb"
                 else (uv, 10))
        femb = x if mr is None else mk.embed_block(uv, 10)  # the faults' input
        what = f"{label} ({n}, {x.shape[1]})"
        in_bytes = x.numel() * x.element_size()
        if rec1 is not None:
            ref = mk.fused_nerf2d_plain(ws, bs, x, mr, bf)
            ref32 = mk.fused_nerf2d_plain(ws, bs, x, mr, f32)
            err = mlp_check(f"K1 mlp_fwd {what}",
                            mk.mlp_fwd_kernel(wflat, bflat, x, mr), ref,
                            ref32, failures)
            if rec1 is not HELD:
                mlp_caught(f"K1 relu6_fwd (layer 6 without its ReLU) at "
                           f"{what}", [planted_mlp(torch, ws, bs, femb, None,
                                                   "relu6_fwd")[0]],
                           [ref], [ref32], failures)
                same = torch.equal(mk.mlp_fwd_kernel(wflat, bflat, x, mr),
                                   mk.mlp_fwd_kernel(wflat, bflat, x, mr))
                print(f"  K1 at {what}: two runs bit-identical {same}")
                if not same:
                    failures.append(f"K1 determinism at {what}")
                timed(rec1, label, err,
                      lambda: mk.mlp_fwd_kernel(wflat, bflat, x, mr),
                      lambda: mk.fused_nerf2d_plain(ws, bs, x, mr, bf),
                      2.0 * n * macs, in_bytes + n * 3 * 4 + wbytes)
            del ref, ref32
        if rec2 is not None:
            g = torch.randn((n, 3), generator=gen, device=dev) * 1e-2
            dws, dbs = mk.mlp_bwd_kernel(wflat, bflat, x, g, mr, wt)
            rws, rbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, mr, bf)
            fws, fbs = mk.fused_nerf2d_bwd_plain(ws, bs, x, g, mr, f32)
            refs, refs32 = rws + rbs, fws + fbs
            err = 0.0
            for i, (a, b, c) in enumerate(zip(dws + dbs, refs, refs32)):
                err = max(err, mlp_check(
                    f"K2 mlp_bwd {label} {'dW' if i < 9 else 'db'}{i % 9} "
                    f"{tuple(b.shape)}", a, b, c, failures))
            if rec2 is not HELD:
                again = mk.mlp_bwd_kernel(wflat, bflat, x, g, mr, wt)
                same = all(torch.equal(a, b)
                           for a, b in zip(dws + dbs, again[0] + again[1]))
                print(f"  K2 at {what}: two runs bit-identical {same}")
                if not same:
                    failures.append(f"K2 determinism at {what}")
                del again
                for fault in ("relu6_mask", "skip_offset", "dropped_chunk"):
                    _, pws, pbs = planted_mlp(torch, ws, bs, femb, g, fault)
                    mlp_caught(f"K2 {fault} at {what}", pws + pbs, refs,
                               refs32, failures)
                    del pws, pbs
                timed(rec2, label, err,
                      lambda: mk.mlp_bwd_kernel(wflat, bflat, x, g, mr, wt),
                      lambda: mk.fused_nerf2d_bwd_plain(ws, bs, x, g, mr, bf),
                      2.0 * n * (3 * macs - 42 * 256),
                      in_bytes + n * 3 * 4 + wbytes
                      + (wflat.numel() + bflat.numel()) * 4)
                mlp_bwd_breakdown(torch, mk, wflat, bflat, wt, x, g, mr)
            del dws, dbs, refs, refs32, rws, rbs, fws, fbs
        del uv, x, femb
        torch.cuda.empty_cache()
    for name, parts in device_total.items():
        print(f"  {name}: device time {sum(t for _, t in parts):.3f} ms "
              f"over {' + '.join(label for label, _ in parts)}")


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


# the K3/K4 call shapes (B, H, Sq, Skv, Se) and the K6 signatures held to
# their plain versions so far in this run: a later path records the ones
# no earlier path ran as shape records of their own
ATTENTION_SEEN = set()
GROUPNORM_SEEN = set()


def attention_shape(args):
    """(B, H, Sq, Skv, Se, d) of a call, as _build.launch_shapes keys it."""
    q, k, _, ek, _ = args
    return (*q.shape[:3], k.shape[2], 0 if ek is None else ek.shape[2],
            q.shape[3])


def check_routed_calls(torch, calls, label, failures):
    """K3/K4 held to attention_limit on every recorded kernel-routed call's
    real inputs. Returns (max |kernel - plain|, K3 calls, K4 calls)."""
    from contexture_nerf_tpu_torch.ops import attention as att

    worst = err = 0.0
    strided = 0
    with torch.no_grad():
        for args in calls:
            ATTENTION_SEEN.add(attention_shape(args))
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


def vae_encoder_groupnorms(h, w):
    """(x shape, act) of each GroupNorm call of one SD VAE encode of a
    (1, 3, h, w) image, in call order (22): two in each resnet, the mid
    attention's (no SiLU), conv_norm_out; all bf16, eps 1e-6, in the SDS
    step (the slice's at 448x448, the canvas's at 960x640)."""
    from contexture_nerf_tpu_torch.diffusion.vae import VAEConfig

    cfg = VAEConfig.sd()
    out, ch = [], cfg.block_out_channels[0]
    for bi, oc in enumerate(cfg.block_out_channels):
        for _ in range(cfg.layers_per_block):
            out += [((1, ch, h, w), True), ((1, oc, h, w), True)]
            ch = oc
        if bi < len(cfg.block_out_channels) - 1:
            h, w = h // 2, w // 2
    mid = (1, ch, h, w)
    return out + [(mid, True)] * 2 + [(mid, False)] + [(mid, True)] * 3


def output_gradient(torch, x, dtype, gen):
    """A gradient of a GroupNorm's output for x: activation-like (channel
    means away from 0, so mean(dxhat) is too) plus x itself (so
    mean(dxhat xhat) is as well): every term of the backward shows."""
    g = activations(torch, tuple(x.shape), torch.float32, gen)
    return (g + x.float()).to(dtype)


def closed_form_bwd(torch, x, scale, bias, g, groups, eps, act,
                    dtype=None, sum_dtype=None, shift=None, fault=None):
    """group_norm_silu_bwd_plain's closed form with each sum a limit or a
    planted fault can move: the elementwise work in `dtype` (default f64),
    the sums taken in `sum_dtype` (default dtype) and rounded to dtype; the
    group sums mean, e2 (E[x^2]), m1 (mean(dxhat)) and m2 (mean(dxhat
    xhat)) moved by `shift`'s amounts; `fault` one of BWD_FAULTS (a stand-in
    for a wrong gn_bwd): "no_slope" takes g' = g sigmoid(y); "no_projection"
    drops xhat m2; "chunk" leaves the middle rank's chunk of gn_bwd's plan
    (for a one-CTA plan the middle quarter of the group) out of m1 and m2,
    still dividing by n. Returns (dx, dscale, dbias) in dtype, |terms| of
    mean, e2, m1, m2 per group, and |terms| of dscale and dbias per
    channel."""
    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    dtype = dtype or torch.float64
    sum_dtype = sum_dtype or dtype
    shift = shift or {}
    B, C = x.shape[:2]
    shape = (1, C) + (1,) * (x.dim() - 2)
    dims = [0] + list(range(2, x.dim()))
    xd = x.to(dtype).reshape(B, groups, -1)
    n = xd.shape[-1]

    def mean_of(t, keep=1.0):
        return (t.to(sum_dtype) * keep).sum(-1, keepdim=True).to(dtype) / n

    mean = mean_of(xd) + shift.get("mean", 0.0)
    e2 = mean_of(xd * xd) + shift.get("e2", 0.0)
    rstd = torch.rsqrt(e2 - mean * mean + eps)
    xhat = ((xd - mean) * rstd).reshape(x.shape)
    sd = scale.to(dtype).reshape(shape)
    gp = g.to(dtype)
    if act:
        y = xhat * sd + bias.to(dtype).reshape(shape)
        sig = torch.sigmoid(y)
        gp = gp * sig * (1 if fault == "no_slope" else (1 + y * (1 - sig)))
    d = (gp * sd).reshape(B, groups, -1)
    xh = xhat.reshape(B, groups, -1)
    keep = torch.ones(n, dtype=dtype, device=x.device)
    if fault == "chunk":
        p = gn.bwd_plan(n, B * groups, x.element_size(), g.element_size(),
                        max_cluster=(gn.max_cluster(bwd=True) if x.is_cuda
                                     else gn.MAX_CLUSTER))
        share = p.chunk if p.cluster > 1 else -(-n // 4)
        parts = -(-n // share)
        keep[(parts // 2) * share:(parts // 2 + 1) * share] = 0
    m1 = mean_of(d, keep) + shift.get("m1", 0.0)
    m2 = mean_of(d * xh, keep) + shift.get("m2", 0.0)
    proj = 0 if fault == "no_projection" else xh * m2
    dx = (rstd * (d - m1 - proj)).reshape(x.shape)
    dscale = (gp * xhat).to(sum_dtype).sum(dims).to(dtype)
    dbias = gp.to(sum_dtype).sum(dims).to(dtype)
    mags = {"mean": xd.abs().mean(-1, keepdim=True), "e2": e2,
            "m1": d.abs().mean(-1, keepdim=True),
            "m2": (d * xh).abs().mean(-1, keepdim=True)}
    return (dx, dscale, dbias, mags, (gp * xhat).abs().sum(dims),
            gp.abs().sum(dims))


def groupnorm_bwd_floor(torch, x, scale, bias, g, groups, eps, act,
                        rho=2.0 ** -14):
    """The part of |gn_bwd - plain| that the rounding of their f32 sums can
    cause, per element of (dx, dscale, dbias): as in statistics_floor, each
    sum is off by at most rho (1024 f32 ulps) of the sum of its terms'
    magnitudes. The f64 closed form is evaluated with mean, E[x^2],
    mean(dxhat) and mean(dxhat xhat) each moved by that much, one at a
    time; the floor is the sum of the moves' effects in magnitude (plus rho
    of the magnitudes summed into dscale and dbias), doubled, since both
    sides err."""
    base = closed_form_bwd(torch, x, scale, bias, g, groups, eps, act)
    floor = [torch.zeros_like(t) for t in base[:3]]
    for k, mag in base[3].items():
        moved = closed_form_bwd(torch, x, scale, bias, g, groups, eps, act,
                                shift={k: rho * mag})
        for f, a, b in zip(floor, moved[:3], base[:3]):
            f += (a - b).abs()
    floor[1] += rho * base[4]
    floor[2] += rho * base[5]
    return [2.0 * f for f in floor]


def groupnorm_bwd_limit(torch, x, scale, bias, g, groups, eps, act, plain):
    """gn_bwd's per-element limits against the closed form's outputs
    `plain` (dx, dscale, dbias; None where not asked): groupnorm_bwd_floor
    plus one ulp of each output's dtype at the plain value's magnitude (the
    two round f32 values that differ by the floor; the elementwise chain's
    own rounding in f32)."""
    floor = groupnorm_bwd_floor(torch, x, scale, bias, g, groups, eps, act)
    out = []
    for f, p in zip(floor, plain):
        if p is None:
            out.append(None)
            continue
        a = p.float().abs().clamp(min=2.0 ** -126)
        mant = 7.0 if p.dtype == torch.bfloat16 else 23.0
        out.append((torch.exp2(torch.floor(torch.log2(a)) - mant)
                    + f.float()).reshape(p.shape))
    return out


def groupnorm_bwd_ratio(torch, got, plain, limit):
    """The largest groupnorm_ratio over the outputs asked for."""
    return max(groupnorm_ratio(torch, a, b, c)
               for a, b, c in zip(got, plain, limit) if b is not None)


BWD_FAULTS = {"no_slope": "SiLU's slope taken as sigmoid(y) alone",
              "no_projection": "the xhat * mean(dxhat xhat) term dropped",
              "chunk": "one CTA's share left out of the group's two sums"}


def planted_group_norm_bwd(torch, x, scale, bias, g, groups, eps, act,
                           fault):
    """The closed form's dx in f32, rounded to x's dtype, with one of
    BWD_FAULTS planted (see closed_form_bwd): a stand-in for a wrong
    gn_bwd."""
    return closed_form_bwd(torch, x, scale, bias, g, groups, eps, act,
                           torch.float32, fault=fault)[0].to(x.dtype)


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
    total = sum(dev.values())
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
    autograd path's gradients (gn_bwd's) against the closed form within
    groupnorm_bwd_limit."""
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

    # the kernel path's gradients against the closed form, within gn_bwd's
    # limit (the plain path's autograd sums in another order)
    g_k = grads(gn.group_norm_silu)
    plain = gn.group_norm_silu_bwd_plain(x, scale, bias, w, 32, 1e-6, True)
    limit = groupnorm_bwd_limit(torch, x, scale, bias, w, 32, 1e-6, True,
                                plain)
    for name, k, p, lim in zip(("dx", "dscale", "dbias"), g_k, plain, limit):
        err = float((k - p).abs().max())
        ratio = groupnorm_ratio(torch, k, p, lim)
        print(f"  K6 autograd (forward K6, backward gn_bwd) {name}: "
              f"max_abs_err from the closed form {err:.3e}, max err/limit "
              f"{ratio:.3f} (limit: groupnorm_bwd_limit, largest "
              f"{float(lim.max()):.3e})")
        if not ratio <= 1.0:
            failures.append(f"K6 autograd gradient {name}")
    return worst



# the SDS step's encodes as (h, w): the backward slice around the sampled
# tile (the default path) and the whole canvas (the exact path)
STEP_SLICE, STEP_CANVAS = (448, 448), (960, 640)
STEP_NEED = (True, False, False)  # the frozen VAE asks gn_bwd for dx alone
GN_BWD_OPS = 40  # gn_bwd's FP32 operations an element, counted high
GN_BWD_SRC = "contexture_nerf_tpu_torch/csrc/groupnorm.cu"
GN_BWD_REPLACES = ("no TPU counterpart (the reference's custom VJP "
                   "recomputes through its plain version)")


# SV3D_p's shapes: K3 at the video UNet's two routed levels (42 frames of
# 72^2 and 36^2 latents), K6 on the frame-stacked (B, C, T, h w) layout of
# the temporal ResBlocks (groups of up to 10 ch x 21 x 72 x 72), a spatial
# ResBlock's and the 21 frames' VAE encode's; gn_bwd at the sampled
# frame's 576^2 encode
SV3D_ATTN = [("level 0", 42, 5, 72 * 72), ("level 1", 42, 10, 36 * 36)]
SV3D_GN = [
    ("time_stack level 0", (2, 320, 21, 72 * 72), 1e-5),
    ("time_stack level 1", (2, 640, 21, 36 * 36), 1e-5),
    ("time_stack level 2", (2, 1280, 21, 18 * 18), 1e-5),
    ("time_stack level 3", (2, 1280, 21, 9 * 9), 1e-5),
    ("spatial resnet level 0", (42, 320, 72, 72), 1e-5),
    ("VAE encode of the 21 frames, level 0", (21, 128, 576, 576), 1e-6)]
SV3D_FRAME = (576, 576)


def _ms(t):
    """A device time as printed: four decimals, or what NotMeasured says."""
    return f"{t:.4f}" if isinstance(t, float) else f"{t}"


def sv3d_kernels(torch, seed, failures):
    """K3 and K6 (forward, then gn_bwd) at SV3D_p's shapes against their
    plain versions, within attention_limit / groupnorm_limit /
    groupnorm_bwd_limit, two runs bit-identical, the planted faults that
    apply outside the limits; device times against their bounds. Returns
    their shape records, keyed as _build.launch_shapes keys launches (a
    K3 or K6 record: one call; the gn_bwd record: the sampled frame's
    encode, 22 calls); record_launches gives them a step's launches."""
    from contexture_nerf_tpu_torch.ops import attention as att
    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    recs = {}
    for label, B, H, S in SV3D_ATTN:
        # q, k, v as CrossAttention passes them: strided views of the
        # projections' (B, S, H d) memory
        qkv = torch.randn((B, S, 3, H, 64), generator=gen,
                          device=dev).to(bf)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        args = (q, k, v, None, None)
        name = f"K3 sv3d {label} ({B} x {H} heads, {S} tokens)"
        attention_check(torch, att, args, failures, name)
        rec = recs[("flash_attn_single", B, H, S, S, 0, 64)] = \
            attention_shape_record(torch, args, "flash_attn_single (sv3d_p's "
                                   f"UNet call, {label}: {B} x {H} heads, "
                                   f"{S} tokens)")
        dms = device_ms(lambda: att.flash_attention(*args), reps=5)
        b_ms, by = bound(4.0 * B * H * S * S * 64,
                         2.0 * B * H * 64 * 4 * S)
        print(f"    a call: device {_ms(dms)} ms, plain "
              f"{rec.d['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({by}); "
              f"{share_of_bound(b_ms, dms)}")
        del qkv, q, k, v, args
        torch.cuda.empty_cache()
    for label, shape, eps in SV3D_GN:
        x = activations(torch, shape, bf, gen)
        C = shape[1]
        scale = (1 + 0.3 * torch.randn((C,), generator=gen,
                                       device=dev)).to(bf)
        bias = (0.2 * torch.randn((C,), generator=gen, device=dev)).to(bf)
        args = (scale, bias, 32, eps, True, bf)
        p = gn.kernel_plan(x)
        got = gn.group_norm_silu_kernel(x, *args)
        same = torch.equal(got, gn.group_norm_silu_kernel(x, *args))
        plain = gn.group_norm_silu_plain(x, *args)
        limit = groupnorm_limit(torch, x, scale, bias, 32, eps, True, plain)
        ratio = groupnorm_ratio(torch, got, plain, limit)
        err = float((got.float() - plain.float()).abs().max())
        ok = ratio <= 1.0 and same and bool(torch.isfinite(got.float()).all())
        name = (f"K6 sv3d {label} {shape} groups of "
                f"{x.numel() // (shape[0] * 32)} [{p.path}, {p.cluster} "
                f"CTA{'s' * (p.cluster > 1)}]")
        print(f"  {name}: max_abs_err {err:.3e}, max err/limit "
              f"{ratio:.3f}, two runs bit-identical {same} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(name)
        for fault, what in FAULTS.items():
            r = groupnorm_ratio(torch, planted_group_norm(
                torch, x, *args, fault), plain, limit)
            print(f"    planted fault {what}: max err/limit {r:.2f} "
                  f"{'caught' if r > 1 else 'NOT CAUGHT'}")
            if not r > 1:
                failures.append(f"{name}: limit passes planted fault {fault}")
        del got, plain, limit

        def k6():
            return gn.group_norm_silu_kernel(x, *args)

        def lib():
            return torch.nn.functional.silu(
                torch.nn.functional.group_norm(x, 32, scale, bias, eps))

        nbytes = groupnorm_bytes(torch, x, bf)
        rec = recs[("groupnorm", *shape)] = Record(
            f"groupnorm (sv3d_p's {label}, {shape})",
            "contexture_nerf_tpu_torch/csrc/groupnorm.cu",
            "contexture_nerf_tpu/ops/groupnorm.py:69", H100_FP32_FLOPS)
        rec.add(err, cuda_ms(k6), cuda_ms(lambda: gn.group_norm_silu_plain(
            x, *args), reps=3), 12.0 * x.numel(), nbytes,
            lib_ms=cuda_ms(lib))
        dms, lms = device_ms(k6, reps=5), device_ms(lib, reps=5)
        b_ms = nbytes / H100_BYTES_S * 1e3
        print(f"    a call: device {_ms(dms)} ms (F.group_norm + F.silu "
              f"{_ms(lms)} ms), bound {b_ms:.3f} ms (bytes); "
              f"{share_of_bound(b_ms, dms)}")
        del x
        torch.cuda.empty_cache()
    rec = recs[("groupnorm_bwd", "sv3d frame")] = Record(
        f"groupnorm_bwd (gn_bwd; sv3d's {SV3D_FRAME[0]}^2 frame encode, 22 "
        "calls)", GN_BWD_SRC, GN_BWD_REPLACES, peak=H100_FP32_FLOPS,
        keys=sorted({("groupnorm_bwd", *shape) for shape, _ in
                     vae_encoder_groupnorms(*SV3D_FRAME)}))
    groupnorm_bwd_phase(torch, seed, [("sv3d frame", SV3D_FRAME, rec)],
                        failures)
    return recs


def record_launches(recs, shapes, where, failures):
    """Each shape record gets the launches of its shapes (keyed as
    _build.launch_shapes keys launches) in `shapes`, the launches of
    `where`; a shape that `where` never launches fails."""
    for key, rec in recs.items():
        rec.d["launches"] = n = sum(shapes.get(k, 0)
                                    for k in rec.keys or [key])
        print(f"  {rec.d['name']}: {n} launches {where}")
        if not n:
            failures.append(f"{rec.d['name']} was not launched {where}")


def sv3d_step(torch, seed, failures):
    """The SV3D_p paint loop at full width on the torus: prepare_sds
    (guide.teacher sv3d_p, without the bootstrap) timed by phase; one step's
    launches held to its census; one step under the profiler: its
    teacher.temporal spans inside sds.teacher (38), its host reads (one);
    then timed steps and the peak memory. Returns the counted step's
    launches by kernel and call sizes (_build.launch_shapes)."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.diffusion.video_unet import \
        temporal_layers
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj"), "teacher": "sv3d_p",
        "text": "a photo of a dairy cow"}, "optim": {"seed": seed}})
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, _ = tr.build_sds_trainer(cfg, device="cuda", timings=timings,
                                      skip_bootstrap=True)
    torch.cuda.synchronize()
    print(f"  built and prepared in {time.perf_counter() - t0:.1f} s; "
          "prepare phases (ms): "
          + ", ".join(f"{k} {v:.0f}" for k, v in timings.items()))
    ts = trainer.t_schedule(5000).tolist()
    trainer.step(ts[1000])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with census() as c:
        trainer.step(ts[1001])
        torch.cuda.synchronize()
    hold_to_census(c, "sv3d step", failures)
    shapes = dict(_build.launch_shapes)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(ts[1002])
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]
    teach = [(a, b) for n, a, b in ev if n == "sds.teacher"]
    temporal = [a for n, a, _ in ev if n == "teacher.temporal"]
    inside = sum(1 for a in temporal
                 if any(lo <= a <= hi for lo, hi in teach))
    reads = sum(1 for n, _, _ in ev if n.startswith("sync."))
    per_call = sum(temporal_layers(trainer.teacher.unet_config))
    ok = len(teach) == 1 and inside == len(temporal) == per_call \
        and reads == 1
    print(f"  one step under the profiler: {len(teach)} sds.teacher, "
          f"{len(temporal)} teacher.temporal ({inside} inside it; a UNet "
          f"call has {per_call}), {reads} host read(s) "
          f"{'ok' if ok else 'MISS'}")
    if not ok:
        failures.append("sv3d step spans")
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        _, loss, *_ = trainer.step(ts[1003 + i])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"  {n} steps: {ms:.1f} ms a step, loss {float(loss):.4g}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"[{card_line()}]")
    if not math.isfinite(float(loss)):
        failures.append("sv3d step loss not finite")
    del trainer, loss
    gc.collect()
    torch.cuda.empty_cache()
    return shapes


def sv3d_phases(torch, seed, failures):
    """SV3D_p's kernel shapes, its paint loop's step, and the shapes'
    records with the step's launches; returns the records."""
    print("SV3D_p's kernel shapes (kernel vs plain, bf16):")
    recs = sv3d_kernels(torch, seed, failures)
    print("SV3D_p's paint loop at full width on the torus")
    shapes = sv3d_step(torch, seed, failures)
    record_launches(recs, shapes, "in the SV3D_p step", failures)
    return recs


# FLUX.1 Depth's K3 calls: the joint attention of its 57 blocks over 2,400
# image + 512 text tokens, 24 heads of 128 (q, k as the RoPE writes them,
# v a strided view of the single block's fused linear1 output, row stride
# 3 h + 4 h = 21,504), and a ragged shape with a tail the kernel masks
FLUX_ATTN = [("joint attention", 1, 24, 2912, 2912, 21504),
             ("ragged", 1, 3, 777, 1234, 0)]
FLUX_BLOCKS = (19, 38)  # double-stream, single-stream


def flux_kernels(torch, seed, failures):
    """K3 at head dim 128 at FLUX.1 Depth's shapes against the plain version
    within attention_limit, two runs bit-identical, the planted faults that
    apply outside the limit, a 192-row query tile refused; device time
    against the bound. Returns the shape records keyed as
    _build.launch_shapes keys launches."""
    from contexture_nerf_tpu_torch.ops import attention as att

    dev, bf, d = torch.device("cuda"), torch.bfloat16, 128
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    recs = {}
    for label, B, H, sq, skv, row in FLUX_ATTN:
        def heads(s):
            return torch.randn((B, s, H, d), generator=gen, device=dev,
                               dtype=bf).permute(0, 2, 1, 3)
        q, k = heads(sq), heads(skv)
        if row:
            fused = torch.randn((B, skv, row), generator=gen, device=dev,
                                dtype=bf)
            v = fused[:, :, 2 * H * d:3 * H * d].unflatten(
                -1, (H, d)).permute(0, 2, 1, 3)
        else:
            v = heads(skv)
        args = (q, k, v, None, None)
        name = f"K3 flux {label} ({B} x {H} heads of {d}, {sq} x {skv})"
        attention_check(torch, att, args, failures, name)
        try:
            att.flash_attention(*args, 192)
            failures.append(f"{name}: a 192-row query tile was not refused")
            print("    a 192-row query tile at d = 128: NOT refused")
        except RuntimeError:
            print("    a 192-row query tile at d = 128: refused")
        key = ("flash_attn_single", B, H, sq, skv, 0, d)
        rec = recs[key] = attention_shape_record(
            torch, args, f"flash_attn_single (flux1-depth-dev's {label}: {B} "
            f"x {H} heads of {d}, {sq} x {skv})")
        dms = device_ms(lambda: att.flash_attention(*args), reps=10)
        flops = 4.0 * B * H * sq * skv * d
        b_ms, by = bound(flops, 2.0 * B * H * d * (2 * sq + 2 * skv))
        tf = f", {flops / dms / 1e9:.0f} TFLOP/s" \
            if isinstance(dms, float) else ""
        print(f"    a call: device {_ms(dms)} ms{tf}, plain "
              f"{rec.d['plain_ms']:.3f} ms, SDPA {rec.d['library_ms']:.3f} "
              f"ms, bound {b_ms:.3f} ms ({by}); {share_of_bound(b_ms, dms)}")
    return recs


def head_dim_launches(shapes, d):
    """K3 launches at head dim d in _build.launch_shapes-keyed `shapes`."""
    return sum(n for key, n in shapes.items()
               if key[0] == "flash_attn_single" and key[-1] == d)


def flux_step(torch, seed, failures):
    """The FLUX.1 Depth paint loop at full width on the torus: prepare_sds
    (guide.teacher flux_depth: no bootstrap) timed by phase; one step's
    launches held to its census, K3's at d = 128 among them (57); one step
    under the profiler: its 19 flux.double and 38 flux.single spans inside
    sds.teacher, an attn.kernel span inside each, one host read; the
    teacher's counters; then timed steps and the peak memory. Returns the
    counted step's launches by kernel and call sizes."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj"),
        "teacher": "flux_depth", "text": "a photo of a dairy cow"},
        "optim": {"seed": seed}})
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, _ = tr.build_sds_trainer(cfg, device="cuda", timings=timings)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in trainer.teacher.transformer.parameters())
    print(f"  built and prepared in {time.perf_counter() - t0:.1f} s "
          f"({n_par:,} MMDiT parameters, {trainer.teacher.dtype}); prepare "
          "phases (ms): " + ", ".join(f"{k} {v:.0f}"
                                      for k, v in timings.items()))
    ts = trainer.t_schedule(5000).tolist()
    trainer.step(ts[1000])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with census() as c:
        trainer.step(ts[1001])
        torch.cuda.synchronize()
    hold_to_census(c, "flux step", failures)
    shapes = dict(_build.launch_shapes)
    d128 = head_dim_launches(shapes, 128)
    want = c.head_dims["flash_attn_single", 128]
    blocks = sum(FLUX_BLOCKS)
    ok = d128 == want == blocks
    print(f"  K3 at head dim 128: {d128} launched, census {want}, blocks "
          f"{blocks} {'ok' if ok else 'MISS'}")
    if not ok:
        failures.append("flux step: K3 launches at head dim 128")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(ts[1002])
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events()]
    teach = [(a, b) for n, a, b in ev if n == "sds.teacher"]
    blk = {n: [(a, b) for m, a, b in ev if m == n]
           for n in ("flux.double", "flux.single")}
    kern = [a for n, a, _ in ev if n == "attn.kernel"]
    inside = all(any(lo <= a <= hi for lo, hi in teach)
                 for iv in blk.values() for a, _ in iv)
    each = all(sum(lo <= a <= hi for a in kern) == 1
               for iv in blk.values() for lo, hi in iv)
    reads = sum(1 for n, _, _ in ev if n.startswith("sync."))
    ok = len(teach) == 1 and inside and each and reads == 1 and \
        (len(blk["flux.double"]), len(blk["flux.single"])) == FLUX_BLOCKS
    print(f"  one step under the profiler: {len(teach)} sds.teacher, "
          f"{len(blk['flux.double'])} flux.double and "
          f"{len(blk['flux.single'])} flux.single (inside it: {inside}; one "
          f"attn.kernel in each: {each}), {reads} host read(s) "
          f"{'ok' if ok else 'MISS'}")
    if not ok:
        failures.append("flux step spans")
    print(f"  the teacher's counters: {json.dumps(trainer.teacher.counts)}")
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        _, loss, *_ = trainer.step(ts[1003 + i])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"  {n} steps: {ms:.1f} ms a step, loss {float(loss):.4g}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"[{card_line()}]")
    if not math.isfinite(float(loss)):
        failures.append("flux step loss not finite")
    del trainer, loss
    gc.collect()
    torch.cuda.empty_cache()
    return shapes


def flux_phases(torch, seed, failures):
    """FLUX.1 Depth's K3 shapes at head dim 128, its paint loop's step, and
    the shapes' records with the step's launches; returns the records."""
    print("FLUX.1 Depth's K3 shapes (kernel vs plain, bf16, head dim 128):")
    recs = flux_kernels(torch, seed, failures)
    print("FLUX.1 Depth's paint loop at full width on the torus")
    shapes = flux_step(torch, seed, failures)
    record_launches({k: v for k, v in recs.items() if k[3] == 2912},
                    shapes, "in the FLUX step", failures)
    return recs


def library_bwd(torch, x, scale, bias, g, groups, eps, act):
    """The library's backward of the same GroupNorm(+SiLU) call, dx alone:
    aten's silu_backward (where act) and native_group_norm_backward, from
    the statistics native_group_norm keeps; a function of no arguments."""
    B, C = x.shape[:2]
    hw = x.numel() // (B * C)
    w, b = scale.to(x.dtype), bias.to(x.dtype)
    y, mean, rstd = torch.ops.aten.native_group_norm(x, w, b, B, C, hw,
                                                     groups, eps)

    def run():
        gy = torch.ops.aten.silu_backward(g, y) if act else g
        return torch.ops.aten.native_group_norm_backward(
            gy, x, mean, rstd, w, B, C, hw, groups, [True, False, False])[0]
    return run


def groupnorm_bwd_phase(torch, seed, encodes, failures):
    """gn_bwd at the SD VAE encoder's 22 GroupNorm calls of each encode in
    `encodes` ((label, (h, w), Record)), bf16 as the SDS step runs them:
    each distinct call within groupnorm_bwd_limit of the closed form, every
    gradient asked and dx alone (STEP_NEED), two runs bit-identical, the
    planted BWD_FAULTS that apply outside the limit; then timed as the step
    asks (dx alone): CUDA events, device time, the plain closed form and
    the library's backward (library_bwd). Each Record gets the sums over
    the 22 calls, the bytes they must move (x and g read once, dx written
    once) and the device times."""
    from contexture_nerf_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    bf, eps, everything = torch.bfloat16, 1e-6, (True, True, True)
    for label, hw, rec in encodes:
        calls = {}
        for shape, act in vae_encoder_groupnorms(*hw):
            calls[(shape, act)] = calls.get((shape, act), 0) + 1
        dms = ldms = 0.0
        for (shape, act), times in calls.items():
            x = activations(torch, shape, bf, gen)
            C = shape[1]
            scale = (1 + 0.3 * torch.randn((C,), generator=gen,
                                           device=dev)).to(bf)
            bias = (0.2 * torch.randn((C,), generator=gen,
                                      device=dev)).to(bf)
            g = output_gradient(torch, x, bf, gen)
            p = gn.bwd_kernel_plan(x, g)
            name = (f"gn_bwd {label} {shape} act {act} [{p.path}, "
                    f"{p.cluster} CTA{'s' * (p.cluster > 1)}]")
            plain = gn.group_norm_silu_bwd_plain(x, scale, bias, g, 32, eps,
                                                 act)
            limit = groupnorm_bwd_limit(torch, x, scale, bias, g, 32, eps,
                                        act, plain)
            ok, line = True, []
            for need in (everything, STEP_NEED):
                args = (x, scale, bias, g, 32, eps, act, need)
                got = gn.group_norm_silu_bwd_kernel(*args)
                again = gn.group_norm_silu_bwd_kernel(*args)
                same = all(a is None or torch.equal(a, b)
                           for a, b in zip(got, again))
                asked = [q if r else None for q, r in zip(plain, need)]
                ratio = groupnorm_bwd_ratio(torch, got, asked, limit)
                finite = all(bool(torch.isfinite(a.float()).all())
                             for a in got if a is not None)
                ok = ok and ratio <= 1.0 and same and finite
                line.append(f"{sum(need)} asked: max err/limit {ratio:.3f}, "
                            f"two runs bit-identical {same}")
            err = float((got[0].float() - plain[0].float()).abs().max())
            print(f"  {name} x{times}: " + "; ".join(line)
                  + f"; dx max_abs_err {err:.3e} {'ok' if ok else 'MISS'}")
            if not ok:
                failures.append(name)
            for fault, what in BWD_FAULTS.items():
                if fault == "no_slope" and not act:
                    continue
                bad = planted_group_norm_bwd(torch, x, scale, bias, g, 32,
                                             eps, act, fault)
                r = groupnorm_ratio(torch, bad, plain[0], limit[0])
                print(f"    planted fault {what}: max err/limit {r:.2f} "
                      f"{'caught' if r > 1 else 'NOT CAUGHT'}")
                if not r > 1:
                    failures.append(f"{name}: limit passes planted fault "
                                    f"{fault}")
            del plain, limit, got, again

            def k():
                return gn.group_norm_silu_bwd_kernel(x, scale, bias, g, 32,
                                                     eps, act, STEP_NEED)

            lib = library_bwd(torch, x, scale, bias, g, 32, eps, act)
            t = {"ms": cuda_ms(k), "lms": cuda_ms(lib),
                 "pms": cuda_ms(lambda: gn.group_norm_silu_bwd_plain(
                     x, scale, bias, g, 32, eps, act, STEP_NEED), reps=5),
                 "dms": device_ms(k), "ldms": device_ms(lib)}
            nbytes = x.numel() * (2 * x.element_size() + g.element_size())
            rec.add(err, t["ms"], t["pms"], GN_BWD_OPS * x.numel(), nbytes,
                    times=times, lib_ms=t["lms"])
            dms, ldms = dms + times * t["dms"], ldms + times * t["ldms"]
            b_ms = nbytes / H100_BYTES_S * 1e3
            print(f"    a call: gn_bwd {t['ms']:.4f} ms (device "
                  f"{t['dms']:.4f}), library {t['lms']:.4f} (device "
                  f"{t['ldms']:.4f}), plain {t['pms']:.4f}, bound {b_ms:.4f} "
                  f"(bytes); device time {share_of_bound(b_ms, t['dms'])}")
            del x, g, lib
            torch.cuda.empty_cache()
        rec.d["device_ms"], rec.d["library_device_ms"] = dms, ldms
        out = rec.out()
        print(f"  gn_bwd over the {label}'s {sum(calls.values())} calls "
              f"({hw[0]}x{hw[1]}): ms "
              f"{out['ms']:.3f} plain_ms {out['plain_ms']:.3f} library_ms "
              f"{out['library_ms']:.3f} bound_ms {out['bound_ms']:.3f} "
              f"({out['bound_by']}); device time gn_bwd {dms:.3f} ms, "
              f"library {ldms:.3f}; gn_bwd "
              f"{share_of_bound(out['bound_ms'], dms)}")

K7_SRC = "contexture_nerf_tpu_torch/csrc/texture.cu"
K7_REPLACES = ("no TPU counterpart (the reference leaves sample_texture to "
               "XLA)")
K7_UNIT = 2.0 ** -24  # float32's unit roundoff
# K7's records: the exact path's 6 target views at the default
# train_grid_size and texture_resolution, keyed as _build.launch_shapes keys
# launches (their launches are the mesh path's exact steps')
K7_VIEWS = 6
K7_FWD_KEY = ("texture_fwd", K7_VIEWS, 1200, 1200, 1024, 1024)
K7_BWD_KEY = ("texture_bwd",) + K7_FWD_KEY[1:]
K7_FAULTS = {"view": "the last view's entries left out of the sums",
             "texel": "each texel's list read from the next texel's"}


def k7_limit(torch, plan, g):
    """Per texel, how far K7's backward may sit from autograd through the
    plain gathers: both sum the same n terms g w (the products rounded
    differently: ((g m) (1 - wy)) (1 - wx) there, g ((m (1 - wy)) (1 -
    wx)) here) in other orders, autograd's a view at a time and then over
    the views, so each is within (n + 6) roundings of the exact sum of
    |g| |w|: (2 n + 12) u S, S that sum, n the texel's entries."""
    from contexture_nerf_tpu_torch.ops import texture as tx

    n = (plan.offsets[1:] - plan.offsets[:-1]).float()
    like = torch.empty(plan.texture_batch, 3, *plan.size, device="meta")
    S = tx.texture_bwd_plain(plan._replace(weight=plan.weight.abs()),
                             g.abs(), like)
    return (2 * n.reshape(plan.texture_batch, 1, *plan.size) + 12) \
        * K7_UNIT * S + 1e-30


def planted_k7_bwd(torch, plan, g, like, fault):
    """K7's backward over a plan with a planted fault (K7_FAULTS)."""
    from contexture_nerf_tpu_torch.ops import texture as tx

    B, H, W = plan.views
    if fault == "view":
        last = plan.pixel.long() >= (B - 1) * H * W
        bad = plan._replace(weight=torch.where(
            last, torch.zeros_like(plan.weight), plan.weight))
    else:
        bad = plan._replace(offsets=torch.cat(
            [plan.offsets[1:], plan.offsets[-1:]]).contiguous())
    return tx.texture_bwd_kernel(bad, g, like)


def texture_cases(torch, seed):
    """K7's cases: (label, uv, mask, texture (permuted, as the MLP hands
    it), mode, timed). The exact path's: the torus's 6 target views at the
    default train_grid_size with the default texture_resolution, bilinear
    (the renderer's mode) and nearest; a ragged one: 2 views of 777 x 1234
    and a 300 x 500 texture, one per view."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel
    from contexture_nerf_tpu_torch.training import trainer as tr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    cfg = config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})
    res, tres = cfg.render.train_grid_size, cfg.guide.texture_resolution
    mm = TexturedMeshModel(cfg.guide, render_grid_size=res,
                           texture_resolution=tres, device=dev)
    cache, _ = tr.define_view_weights(mm, cfg.render)
    uv6 = cache.uv_features[1:].contiguous()
    mask6 = cache.mask[1:].contiguous()
    th, ph, r = tr.view_angles(cfg.render)
    rag = mm.render_geometry(th[1:3], ph[1:3], r[1:3], dims=(1234, 777))

    def tex(batch, h, w):
        return torch.rand((batch, h, w, 3), generator=gen,
                          device=dev).permute(0, 3, 1, 2)

    big = tex(1, tres, tres)
    views = f"{uv6.shape[0]}x{res}^2, texture {tres}^2"
    return [(f"exact path {views}, bilinear", uv6, mask6, big, "bilinear",
             True),
            (f"exact path {views}, nearest", uv6, mask6, big, "nearest",
             True),
            ("ragged 2x777x1234, texture 2x300x500, bilinear",
             rag.uv_features.contiguous(), rag.mask.contiguous(),
             tex(2, 300, 500), "bilinear", False)]


def texture_phase(torch, seed, recs, failures):
    """K7 in each of `texture_cases`: the forward against
    `masked_sample_plain` (bit for bit); the backward over the case's plan
    against the plain segment sum on the CPU (bit for bit), against
    autograd through the plain gathers (within k7_limit), twice
    bit-identical, and the planted K7_FAULTS outside the limit. Timed
    (the exact path's cases): CUDA events and device time of each kernel
    beside its bytes' bound, the plain forward and backward (autograd, its
    scatter-adds), the plan's build and its kept share. The bilinear exact
    case fills `recs` at K7_FWD_KEY and K7_BWD_KEY."""
    from contexture_nerf_tpu_torch.ops import texture as tx

    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    for label, uv, mask, tex, mode, timed in texture_cases(torch, seed):
        B, H, W = uv.shape[:3]
        Bt, _, TH, TW = tex.shape
        P, T = B * H * W, Bt * TH * TW
        plan = tx.texture_plan(uv, mask, (TH, TW), mode, Bt)
        masked = int((mask != 0).sum())
        out = tx.texture_fwd_kernel(uv, mask, tex, mode)
        plain = tx.masked_sample_plain(uv, mask, tex, mode)
        fwd_same = torch.equal(out, plain)
        g = torch.randn((B, 3, H, W), generator=gen, device=dev)
        got = tx.texture_bwd_kernel(plan, g, tex)
        again = tx.texture_bwd_kernel(plan, g, tex)
        same = torch.equal(got, again)
        cpu_plan = tx.TexturePlan(*(t.cpu() for t in plan[:3]), *plan[3:])
        on_cpu = torch.equal(got.cpu(), tx.texture_bwd_plain(
            cpu_plan, g.cpu(), tex.cpu()))
        t = tex.detach().clone().requires_grad_(True)
        tx.masked_sample_plain(uv, mask, t, mode).backward(g)
        limit = k7_limit(torch, plan, g)
        ratio = float(((got - t.grad).abs() / limit).max())
        layout = got.stride() == tex.stride()
        ok = fwd_same and same and on_cpu and ratio <= 1.0 and layout and \
            bool(torch.isfinite(got).all())
        print(f"  K7 {label}: forward bit-identical to plain {fwd_same}; "
              f"backward bit-identical to the plain segment sum on the CPU "
              f"{on_cpu}, two runs bit-identical {same}, against autograd "
              f"max err/limit {ratio:.3f}, in the texture's layout {layout}"
              f"; plan kept share {plan.kept:.4f} ({plan.pixel.numel()} "
              f"entries, {masked} of {P} pixels masked) "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"K7 {label}")
        for fault, what in K7_FAULTS.items():
            bad = planted_k7_bwd(torch, plan, g, tex, fault)
            r = float(((bad - t.grad).abs() / limit).max())
            print(f"    planted fault {what}: max err/limit {r:.2f} "
                  f"{'caught' if r > 1 else 'NOT CAUGHT'}")
            if not r > 1:
                failures.append(f"K7 {label}: limit passes planted fault "
                                f"{fault}")
        del again, t, limit, bad
        if not timed:
            continue

        def fwd():
            return tx.texture_fwd_kernel(uv, mask, tex, mode)

        def bwd():
            return tx.texture_bwd_kernel(plan, g, tex)

        def plain_step():
            t = tex.detach().requires_grad_(True)
            tx.masked_sample_plain(uv, mask, t, mode).backward(g)
            return t.grad

        fwd_bytes = 4 * P + 8 * masked + 12 * P + 12 * T
        bwd_bytes = (8 * plan.pixel.numel() + 4 * (T + 1) + 12 * masked
                     + 12 * T)
        tm = {"fms": cuda_ms(fwd), "fdms": device_ms(fwd),
              "bms": cuda_ms(bwd), "bdms": device_ms(bwd),
              "pfms": cuda_ms(lambda: tx.masked_sample_plain(uv, mask, tex,
                                                             mode), reps=5),
              "pms": cuda_ms(plain_step, reps=5),
              "plan": cuda_ms(lambda: tx.texture_plan(uv, mask, (TH, TW),
                                                      mode, Bt), reps=3)}
        fb, bb = (fwd_bytes / H100_BYTES_S * 1e3,
                  bwd_bytes / H100_BYTES_S * 1e3)
        print(f"    forward {tm['fms']:.4f} ms (device {_ms(tm['fdms'])}), "
              f"bound {fb:.4f} (bytes: {fwd_bytes / 1e6:.1f} MB), device "
              f"time {share_of_bound(fb, tm['fdms'])}; plain forward "
              f"{tm['pfms']:.3f}")
        print(f"    backward {tm['bms']:.4f} ms (device {_ms(tm['bdms'])}), "
              f"bound {bb:.4f} (bytes: {bwd_bytes / 1e6:.1f} MB), device "
              f"time {share_of_bound(bb, tm['bdms'])}; plain ms (forward + "
              f"autograd's backward) {tm['pms']:.3f}; the plan's build "
              f"{tm['plan']:.2f} ms [{card}]")
        if mode == "bilinear":
            fwd_rec, bwd_rec = recs[K7_FWD_KEY], recs[K7_BWD_KEY]
            fwd_rec.add(0.0, tm["fms"], tm["pfms"], 0, fwd_bytes)
            bwd_rec.add(float((got - plain_step()).abs().max()), tm["bms"],
                        tm["pms"], 0, bwd_bytes)
            fwd_rec.d["device_ms"], bwd_rec.d["device_ms"] = (tm["fdms"],
                                                             tm["bdms"])
            bwd_rec.d["kept_share"], bwd_rec.d["plan_ms"] = (plan.kept,
                                                            tm["plan"])
        del plan, out, plain, got, g
        torch.cuda.empty_cache()


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


def groupnorm_signature_times(torch, sigs, failures, label, per_sig=None):
    """K6, its plain version and the library's F.group_norm (+ F.silu: two
    calls) timed at each signature's sample input (a real activation of the
    main path), and K6 held against the plain version there within
    groupnorm_limit. Each signature is timed with CUDA events (cuda_ms), as
    device time (profiler) and as host microseconds a call, K6's and the
    library's; the path of K6's plan is noted. Prints the sums by path and
    the largest signatures, writes every signature's row to
    chiprun_out/k6_signatures_<label>.txt, and returns (ms, plain_ms,
    library_ms, max_abs_err, device_ms, library_device_ms), each summed over
    the signatures' calls; `per_sig`, when given, gets each signature's
    {"n", "ms", "pms", "lms", "err", "bytes", "numel"}, a call's numbers."""
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
        key = (shape, dt, odt, eps, act)
        GROUPNORM_SEEN.add(key)
        if per_sig is not None:
            per_sig[key] = {"n": n, "ms": t["ms"], "pms": t["pms"],
                            "lms": t["lms"], "bytes": nbytes,
                            "numel": x.numel(), "err": float(
                                (got.float() - plain.float()).abs().max())}
    print(f"    K6 held to its limit at {len(sigs)} shapes: largest "
          f"err/limit {worst:.3f}")
    for path, (k, n, d, ld, b_ms) in sorted(paths.items()):
        print(f"    path {path}: {k} shapes, {n} calls; device time K6 "
              f"{d:.3f} ms, library {ld:.3f}, bound {b_ms:.3f} (bytes); K6 "
              f"{share_of_bound(b_ms, d)}")
    k, n, d, ld, b_ms = (sum(v) for v in zip(*paths.values()))
    print(f"    all paths: {k} shapes, {n} calls; device time K6 {d:.3f} ms, "
          f"library {ld:.3f}, bound {b_ms:.3f} (bytes); K6 "
          f"{share_of_bound(b_ms, d)}")
    lines = []
    for nb, n, shape, dt, odt, path, cs, t, hu, lhu, b_ms in sorted(
            rows, key=lambda r: r[0], reverse=True):
        lines.append(
            f"{n} x {shape} {dt}->{odt} [{path}, {cs} CTA{'s' * (cs > 1)}]: "
            f"K6 {t['ms']:.4f} ms (device {t['dms']:.4f}, host "
            f"{hu:.1f} us), library {t['lms']:.4f} (device "
            f"{t['ldms']:.4f}, host {lhu:.1f} us), plain {t['pms']:.4f}, "
            f"bound {b_ms:.4f} (bytes) a call; device time "
            f"{share_of_bound(b_ms, t['dms'])}")
    for line in lines[:6]:
        print("    " + line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"k6_signatures_{label}.txt").write_text("\n".join(lines) + "\n")
    return (tot["ms"], tot["pms"], tot["lms"], err, tot["dms"],
            tot["ldms"])


def main_config(seed):
    """The main path's config: the defaults on shapes/torus.obj."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict

    return config_from_dict({"optim": {"seed": seed}, "guide": {
        "text": "a photo of a dairy cow",
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})


def teacher_v_pred_check(torch, seed, trainer, t, failures):
    """`teacher_v_pred`, the public single-step teacher, at the main path's
    shapes: one SDS step with its teacher call recorded, then
    teacher_v_pred on the trainer's conditioning at that call's noised
    latent and write-pass draws, which must equal the step's v-prediction
    bit for bit; with a planted guidance scale of 1 for 10 it must not;
    and with its draws taken from a generator it must equal the call on
    the same draws given as tensors. Returns the launches, each run's held
    to its census."""
    import inspect

    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.training import trainer as tr

    tch, dev = trainer.teacher, trainer.device
    launches = {k: 0 for k in _build.launch_counts}
    seen = {}
    real = tch._cfg_v_pred

    def recorded(*a, **k):
        out = real(*a, **k)
        seen.update(inspect.signature(real).bind(*a, **k).arguments,
                    out=out.clone())
        return out

    tch._cfg_v_pred = recorded
    try:
        counted(torch, lambda: trainer.step(t),
                "teacher_v_pred: an SDS step, its teacher call recorded",
                launches, failures)
    finally:
        del tch._cfg_v_pred

    def call(label, scale, *noises, **kw):
        with torch.no_grad():
            return counted(torch, lambda: tch.teacher_v_pred(
                seen["latents"], seen["t"], trainer.cond_lat_pair,
                trainer.ehs, trainer.depth_grid, scale, *noises,
                cn_cond_emb=trainer.cn_cond_emb, **kw),
                f"teacher_v_pred, {label}", launches, failures)

    draws = (seen["neg_noise"], seen["cond_noise"])
    got, secs = call("the step's draws", tr.GUIDANCE_SCALE, *draws)
    planted, _ = call("a planted guidance scale of 1", 1.0, *draws)
    gen = torch.Generator(device=dev)
    drawn, _ = call("draws from a generator", tr.GUIDANCE_SCALE,
                    generator=gen.manual_seed(seed + 11))
    gen.manual_seed(seed + 11)
    given, _ = call("the same draws as tensors", tr.GUIDANCE_SCALE,
                    *(torch.randn(d.shape, generator=gen, device=dev)
                      for d in draws))
    step_call = (seen["guidance_scale"] == tr.GUIDANCE_SCALE
                 and seen["scale_input"] is None)
    same = torch.equal(got, seen["out"])
    caught = not torch.equal(planted, seen["out"])
    same_gen = torch.equal(drawn, given)
    print(f"  teacher_v_pred at the step's inputs (latent "
          f"{tuple(seen['latents'].shape)}, t {int(seen['t'])}, CFG "
          f"{seen['guidance_scale']}, identity input scale "
          f"{seen['scale_input'] is None}): {1e3 * secs:.1f} ms, equal to the "
          f"step's teacher call bit for bit {same}; a planted guidance scale "
          f"of 1 {'caught' if caught else 'NOT CAUGHT'} (max abs diff "
          f"{float((planted - seen['out']).abs().max()):.3e}); generator "
          f"draws = the same draws as tensors {same_gen}; finite "
          f"{bool(torch.isfinite(got).all())} [{card_line()}]")
    if not (step_call and same and same_gen
            and bool(torch.isfinite(got).all())):
        failures.append("teacher_v_pred differs from the step's teacher call")
    if not caught:
        failures.append("teacher_v_pred's check passes a planted guidance "
                        "scale of 1")
    return launches


def teacher_graphs_line(torch, teacher, label):
    """Print the teacher's CUDA-graph counters (captures, replays, eager
    calls by reason, fallbacks), the bytes its graphs keep allocated, and
    the card's allocated and reserved memory."""
    print(f"  teacher graphs, {label}: {json.dumps(teacher.graphs.stats())}; "
          f"allocated {torch.cuda.memory_allocated()} B, reserved "
          f"{torch.cuda.memory_reserved()} B")


def census_cost(torch, trainer, t, rounds=2):
    """What the census's hooks cost a step: steps without it and under it
    in turns, each on the host clock with the card synchronised; prints
    the medians."""
    from contexture_nerf_tpu_torch.tools.launches import census

    times = {False: [], True: []}
    trainer.step(t)  # the teacher's graphs captured, if they were dropped
    for _ in range(rounds):
        for on in (False, True):
            torch.cuda.synchronize()
            with census() if on else contextlib.nullcontext():
                a = time.perf_counter()
                trainer.step(t)
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - a) * 1e3)
    off, on = (sorted(times[k])[rounds // 2] for k in (False, True))
    print(f"  the census's cost: a step {off:.1f} ms without it, {on:.1f} ms "
          f"under it (medians of {rounds}, in turns) [{card_line()}]")


def routing_faults(torch, trainer, t, failures):
    """The census check must fail on each planted routing fault, in one
    replayed teacher call at the step's shapes (the faulted calls run
    eagerly between its graphs): one GroupNormSiLU call on the plain
    version with a CUDA tensor, one kernel-routed attention call on the
    plain route."""
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops import attention as att
    from contexture_nerf_tpu_torch.ops import groupnorm as gn
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    dev = trainer.device
    g = torch.Generator(device=dev).manual_seed(0)
    z = torch.randn(trainer.latent_shape(), generator=g,
                    device=dev).to(trainer.dtype)
    graphs = trainer.teacher.graphs

    def call():
        trainer.teacher.teacher_v_pred(
            z, torch.tensor([int(t)], device=dev), trainer.cond_lat_pair,
            trainer.ehs, trainer.depth_grid, tr.GUIDANCE_SCALE, generator=g,
            cn_cond_emb=trainer.cn_cond_emb)

    with torch.no_grad():
        call()  # the key's graphs captured, if these shapes are new
        call()
    for what, module, name, plain in (
            ("one GroupNormSiLU call on the plain version", gn,
             "group_norm_silu", gn.group_norm_silu_plain),
            ("one kernel-routed attention call on the plain route", att,
             "flash_attention", att.flash_attention_plain)):
        real, calls = getattr(module, name), []

        def once(*args, real=real, plain=plain, calls=calls):
            calls.append(1)
            return (plain if len(calls) == 1 else real)(*args)

        setattr(module, name, once)
        replays = graphs.counts["replays"]
        try:
            _build.reset_launch_counts()
            with torch.no_grad(), census() as c:
                call()
                torch.cuda.synchronize()
        finally:
            setattr(module, name, real)
        bad = c.unmatched(_build.launch_counts)
        replayed = graphs.counts["replays"] == replays + 1
        print(f"  planted fault, {what}, in a replayed teacher call: "
              f"(launched, census) {json.dumps(bad)} "
              f"{'caught' if bad else 'NOT CAUGHT'}"
              f"{'' if replayed else ' (the call did not replay)'}")
        if not bad:
            failures.append(f"the census check passes a planted fault: "
                            f"{what}")
        if not replayed:
            failures.append(f"the planted fault's teacher call ({what}) "
                            "did not replay the teacher's graphs")


def main_path(torch, seed, profile, recs, failures):
    from contexture_nerf_tpu_torch.diffusion.sd_depth import \
        StableDiffusionDepth
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    cfg = main_config(seed)
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
    with census() as prep_census:
        trainer, setup = tr.build_sds_trainer(cfg, device="cuda",
                                              timings=timings, diffusion=sd)
        torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
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
    print(f"  build_sds_trainer (teacher init + prepare_sds + trainer; "
          f"under the census) {built_s:.1f} s: teacher "
          f"{n_params / 1e6:.1f} M params ({n_clip / 1e6:.1f} M of them "
          f"CLIP) in {trainer.dtype}, canvas "
          f"{trainer.grid_hw}, backward slice {trainer.sl_h}x{trainer.sl_w}")
    if (trainer.sl_h, trainer.sl_w) != STEP_SLICE or \
            trainer.grid_hw != STEP_CANVAS:
        failures.append(f"the step's slice and canvas are not {STEP_SLICE} "
                        f"and {STEP_CANVAS}, where gn_bwd was held")
    print(f"  prepare_sds {prep_ms:.1f} ms (bootstrap {boot_ms:.1f}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
          + f" ms; peak memory {prep_peak:.2f} GiB")
    prep = hold_to_census(prep_census, "build_sds_trainer", failures)
    check_setup(torch, setup, trainer, cfg.render.train_grid_size, failures)

    # K6's share of prepare_sds, from one more call of each part with the
    # GroupNorms hooked: 51 UNet calls, the decode, the two condition encodes
    steps = len(sd.scheduler.timesteps(tr.BOOTSTRAP_STEPS))
    lat = torch.randn(sd.latent_shape(), device=dev)
    lat_in = torch.cat([torch.cat([lat] * 2), torch.randn(
        (2, 1) + sd.latent_shape()[2:], device=dev)], 1)
    text = sd.get_text_embeds([cfg.guide.text])
    with torch.no_grad(), census(keep_calls=True) as boot:
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
    if p_calls != prep_census.counts["groupnorm"]:
        failures.append(f"K6's parts of prepare_sds: {p_calls} calls != the "
                        f"census's {prep_census.counts['groupnorm']}")
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
    # K3 on the bootstrap UNet call's real self-attention inputs; its
    # routed calls, times the steps, are prepare_sds's
    err, single, _ = check_routed_calls(torch, boot.calls,
                                        "a bootstrap UNet call", failures)
    recs["flash_attn_single"].d["max_abs_err"] = max(
        recs["flash_attn_single"].d["max_abs_err"], err)
    if steps * single != prep_census.counts["flash_attn_single"]:
        failures.append(f"K3 in prepare_sds: {steps} x {single} routed calls "
                        f"!= the census's "
                        f"{prep_census.counts['flash_attn_single']}")
    del sd, parts, sigs, lat, lat_in, text, boot
    torch.cuda.empty_cache()

    # every step under the census (what it costs a step: census_cost below)
    init = {k: v.clone() for k, v in trainer.mlp.state_dict().items()}
    ts = trainer.t_schedule(1000).tolist()[100:104]
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(prep, 0)
    step_ms, losses = [], []
    for i, t in enumerate(ts):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        with census() as c:
            a = time.perf_counter()
            params, loss, gnorm, fisher, grid = trainer.step(t)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - a) * 1e3
        print(f"  step {i} ({'warm-up' if i == 0 else 'timed'}) t={t}: "
              f"loss {float(loss):.6g} grad_norm {float(gnorm):.6g} fisher "
              f"{float(fisher):.6g} {ms:.1f} ms")
        got = hold_to_census(c, f"step {i}", failures)
        for k in launches:
            launches[k] += got[k]
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
    changed = any(not torch.equal(init[k], params[k]) for k in init)
    checked = teacher_v_pred_check(torch, seed, trainer, ts[-1], failures)
    launches = {k: prep[k] + launches[k] + checked[k] for k in prep}
    if not changed:
        failures.append("params did not change")
    step_ms.sort()
    med = step_ms[len(step_ms) // 2]
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  SDS step median {med:.1f} ms "
          f"(timed {', '.join(f'{m:.1f}' for m in step_ms)}), peak memory "
          f"{mem:.2f} GiB, params changed: {changed} [{card_line()}]")

    teacher_graphs_line(torch, trainer.teacher, "after the timed steps")
    # K6 and the routed attention calls on one more step, hooked. The
    # teacher's graphs are dropped for it: the census keeps the routed
    # calls' inputs, which in a replay are views of the graphs' pool that
    # later graphs overwrite
    trainer.teacher.graphs.clear()
    _build.reset_launch_counts()
    with census(keep_calls=True) as c:
        k6 = groupnorm_traffic(torch, [trainer.teacher],
                               lambda: trainer.step(ts[-1]))
    hold_to_census(c, "one SDS step, hooked", failures)
    err, _, _ = check_routed_calls(torch, c.calls, "one SDS step", failures)
    del c
    for key in ("flash_attn_single", "flash_attn_two_source"):
        recs[key].d["max_abs_err"] = max(recs[key].d["max_abs_err"], err)
    print(f"  K6 on one step: {k6['calls']} GroupNorm calls, "
          f"{k6['bytes'] / 1e9:.3f} GB to move (x read once, y written "
          f"once), bound_ms {k6['bound_ms']:.3f} ({k6['bound_by']}); stream "
          f"time K6 {k6['stream_ms']:.2f} ms (CUDA events around each call, "
          f"launch gaps included)")
    if k6["calls"] != got["groupnorm"]:
        failures.append(f"K6 in a step: {k6['calls']} hooked calls != "
                        f"{got['groupnorm']} launches")
    census_cost(torch, trainer, ts[-1])
    routing_faults(torch, trainer, ts[-1], failures)
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


# -- the W8A8 teacher (optim.int8_controlnet / optim.int8_teacher) -------------------

INT8_MODES = (("bf16", False, False), ("int8_controlnet", True, False),
              ("int8_teacher", False, True))
INT8_FAULTS = {
    "dense_per_tensor": "one activation scale over a Dense input for "
                        "per-row scales",
    "conv_per_sample": "one activation scale per sample of a conv's CFG "
                       "batch for one over the batch",
    "weight_per_input": "a conv's weight scales per input channel for per "
                        "output channel",
}


def bf16_ulp(torch, y):
    """One bf16 ulp at each element of y (8 significant bits)."""
    _, e = torch.frexp(y.float())
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def int8_parts(torch, x, w, kind, stride, pad):
    """(q_x, s_x, q_w, s_w, int32 sums, output) of a W8A8 Dense (kind
    "dense", w (N, K)) or conv (w (O, I, kh, kw)) on x's device."""
    from contexture_nerf_tpu_torch.ops import quant as Q

    if kind == "dense":
        q_x, s_x = Q.quantize_int8(x, (-1,))
        q_w, s_w = Q.quantize_int8(w, (1,))
        acc = Q.linear_int32(q_x, q_w)
        return q_x, s_x, q_w, s_w, acc, Q.int8_linear(x, w)
    q_x, s_x = Q.quantize_int8(x, (0, 1, 2, 3))
    q_w, s_w = Q.quantize_int8(w, (1, 2, 3))
    acc = Q.conv2d_int32(q_x, q_w, stride, pad)
    return q_x, s_x, q_w, s_w, acc, Q.int8_conv2d(x, w, stride, pad)


def planted_int8(torch, x, w, stride, pad, fault):
    """The output of the W8A8 op with one planted fault."""
    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.ops import quant as Q

    if fault == "dense_per_tensor":
        q_x, s_x = Q.quantize_int8(x, tuple(range(x.dim())))
        q_w, s_w = Q.quantize_int8(w, (1,))
        return (Q.linear_int32(q_x, q_w).float() * s_x * s_w.reshape(-1)
                ).to(x.dtype)
    if fault == "conv_per_sample":
        q_x, s_x = Q.quantize_int8(x, (1, 2, 3))
        q_w, s_w = Q.quantize_int8(w, (1, 2, 3))
        return (Q.conv2d_int32(q_x, q_w, stride, pad).float() * s_x
                * s_w.reshape(1, -1, 1, 1)).to(x.dtype)
    # weight_per_input: no per-output factor comes out of the sum, so this
    # fault's arithmetic is dequantized and summed in f32
    q_x, s_x = Q.quantize_int8(x, (0, 1, 2, 3))
    q_w, s_w = Q.quantize_int8(w, (0, 2, 3))
    return F.conv2d(q_x.float() * s_x, q_w.float() * s_w, stride=stride,
                    padding=pad).to(x.dtype)


def beyond_ulp(torch, got, ref):
    """(elements of got unequal to ref, elements more than one bf16 ulp of
    ref away from it)."""
    d = (got.float() - ref.float()).abs()
    return int((d > 0).sum()), int((d > bf16_ulp(torch, ref)).sum())


def int8_draws(torch, trainer, seed):
    """A teacher call's inputs: a noised latent and the write-pass noises."""
    g = torch.Generator(device=trainer.device).manual_seed(seed + 8)
    shape, cshape = trainer.latent_shape(), tuple(
        trainer.cond_lat_pair.shape[1:])

    def normal(*s):
        return torch.randn(s, generator=g, device=trainer.device)

    return {"z": 0.5 * normal(*shape), "noise": normal(*shape),
            "neg_noise": normal(*cshape), "cond_noise": normal(*cshape)}


def teacher_call(torch, trainer, lat, t, d, scale_input=None):
    """The SDS step's teacher call (write pass, ControlNet, read pass, CFG
    at 10) at the latent `lat`, on the trainer's cached conditioning, with
    d's write-pass noises."""
    from contexture_nerf_tpu_torch.training import trainer as tr

    t_t = torch.tensor([int(t)], device=trainer.device)
    with torch.no_grad():
        return trainer.teacher._cfg_v_pred(
            lat, t_t, trainer.cond_lat_pair, trainer.ehs, trainer.depth_grid,
            tr.GUIDANCE_SCALE, d["neg_noise"], d["cond_noise"],
            cn_cond_emb=trainer.cn_cond_emb, scale_input=scale_input)


def sds_latent(torch, trainer, d, t):
    """The draws' clean latent DDPM-noised to t, as the step noises it."""
    from contexture_nerf_tpu_torch.diffusion import schedulers as sch

    t_t = torch.tensor([int(t)], device=trainer.device)
    return sch.add_noise(trainer.acp, d["z"], d["noise"], t_t)


def int8_layer_calls(torch, trainer, d, t):
    """One int8_teacher teacher call with every quantized layer hooked.
    Returns ({kind: calls}, {kind: the largest call by operations: (layer,
    x, w, stride, padding, operations)}); a kind is "dense", "conv3x3/s1",
    "conv3x3/s2" or "conv1x1/s1"."""
    import torch.nn as nn

    calls, largest, hooks = {}, {}, []

    def hook(name):
        def fn(mod, args):
            x = args[0].to(mod.weight.dtype)
            if isinstance(mod, nn.Conv2d):
                k, s, p = mod.kernel_size[0], mod.stride[0], mod.padding[0]
                kind = f"conv{k}x{k}/s{s}"
                ho = (x.shape[2] + 2 * p - k) // s + 1
                wo = (x.shape[3] + 2 * p - k) // s + 1
                ops = 2.0 * x.shape[0] * ho * wo * mod.weight.numel()
            else:
                kind, s, p = "dense", 1, 0
                ops = 2.0 * (x.numel() // x.shape[-1]) * mod.weight.numel()
            calls[kind] = calls.get(kind, 0) + 1
            if kind not in largest or ops > largest[kind][-1]:
                largest[kind] = (name, x.detach().clone(),
                                 mod.weight.detach(), s, p, ops)
        return fn

    for tname in ("unet", "controlnet"):
        for name, m in getattr(trainer.teacher, tname).named_modules():
            if getattr(m, "quant", False):
                hooks.append(m.register_forward_pre_hook(
                    hook(f"{tname}.{name}")))
    try:
        teacher_call(torch, trainer, sds_latent(torch, trainer, d, t), t, d)
    finally:
        for h in hooks:
            h.remove()
    return calls, largest


def int8_kernel_count(torch, fn):
    """CUDA kernels launched by one fn() call, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in p.events() if e.device_type == DeviceType.CUDA)


def int8_path(torch, seed, trainer, failures):
    """The W8A8 teacher at full width, on the main path's trainer. (1) One
    int8_teacher teacher call with every quantized layer hooked: per kind
    (Dense, 3x3 stride 1 and 2, 1x1 conv) its largest call, quantized on
    the card and on the CPU from the same inputs: q, the scales and the
    int32 sums equal bit for bit, the bf16 outputs equal or within one
    bf16 ulp; three planted faults must miss that. (2) Each kind's largest
    call timed by part (quantize, patches, _int_mm, rescale) beside the
    bf16 cuDNN conv or cuBLAS GEMM of the same shape. (3) The CUDA kernels
    a teacher call launches in bf16 and with int8_teacher. (4) SDS steps
    with bf16, int8_controlnet and int8_teacher in turns (one warm-up
    each, then three rounds), each step's launches held to its census,
    losses finite; median ms and peak memory by mode. (5) The
    int8-vs-bf16 v-prediction error (printed, not gated: random towers)
    and a generate step (the Euler loop body of
    Zero123PlusPipeline.generate) in bf16 and with int8_teacher. The
    teacher is left in bf16. Returns (launches by kernel, seconds)."""
    import copy

    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.diffusion import schedulers as sch
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops import quant as Q
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    dev = trainer.device
    launches = {k: 0 for k in _build.launch_counts}
    cfgs = {}
    for mode, cn, un in INT8_MODES:
        cfgs[mode] = copy.deepcopy(trainer.cfg)
        cfgs[mode].optim.int8_controlnet = cn
        cfgs[mode].optim.int8_teacher = un
    d = int8_draws(torch, trainer, seed)
    t_call = 500
    lat = sds_latent(torch, trainer, d, t_call)

    # (1) the largest quantized calls, on the card and on the CPU
    tr.apply_int8(cfgs["int8_teacher"], trainer.teacher)
    calls, largest = int8_layer_calls(torch, trainer, d, t_call)
    print(f"  quantized calls in one teacher call: {json.dumps(calls)}")
    for kind, (name, x, w, s, p, ops) in sorted(largest.items()):
        qk = "dense" if kind == "dense" else "conv"
        card_parts = int8_parts(torch, x, w, qk, s, p)
        cpu_parts = int8_parts(torch, x.cpu(), w.cpu(), qk, s, p)
        same = [torch.equal(a.cpu(), b) for a, b in
                zip(card_parts[:5], cpu_parts[:5])]
        uneq, beyond = beyond_ulp(torch, card_parts[5].cpu(), cpu_parts[5])
        ok = all(same) and beyond == 0
        print(f"  {kind} {name} x {tuple(x.shape)} w {tuple(w.shape)} "
              f"({ops / 1e9:.2f} GOP): q_x, s_x, q_w, s_w, int32 sums equal "
              f"to the CPU's {same}; bf16 output: {uneq} of "
              f"{card_parts[5].numel()} elements unequal, {beyond} beyond "
              f"one bf16 ulp {'ok' if ok else 'BAD'}")
        if not ok:
            failures.append(f"int8 {kind} {name}: card != CPU")
        faults = {"dense": ["dense_per_tensor"],
                  "conv3x3/s1": ["conv_per_sample", "weight_per_input"]}
        for fault in faults.get(kind, []):
            bad = planted_int8(torch, x, w, s, p, fault)
            _, missed = beyond_ulp(torch, bad.cpu(), cpu_parts[5])
            print(f"    planted fault ({INT8_FAULTS[fault]}): {missed} "
                  f"elements beyond one bf16 ulp "
                  f"{'caught' if missed else 'NOT CAUGHT'}")
            if not missed:
                failures.append(f"int8 planted fault {fault} not caught")
        del card_parts, cpu_parts

        # (2) the parts' times beside the bf16 library op of the shape
        parts = {"quantize x": lambda: Q.quantize_int8(
            x, (-1,) if qk == "dense" else (0, 1, 2, 3)),
            "quantize w": lambda: Q.quantize_int8(
                w, (1,) if qk == "dense" else (1, 2, 3))}
        q_x, s_x = parts["quantize x"]()
        q_w, s_w = parts["quantize w"]()
        if qk == "dense":
            a, b = q_x.reshape(-1, q_x.shape[-1]), q_w.t()
            acc = Q.int_mm(a, b)
            whole = lambda: Q.int8_linear(x, w)  # noqa: E731
            library = lambda: F.linear(x, w)  # noqa: E731
            sw = s_w.reshape(-1)
            sx = s_x.reshape(-1, 1)
        else:
            kh = w.shape[2]
            parts["patches"] = lambda: Q.conv_patches(q_x, kh, kh, s, p)
            a, _ = parts["patches"]()
            b = q_w.reshape(w.shape[0], -1).t()
            acc = Q.int_mm(a, b)
            whole = lambda: Q.int8_conv2d(x, w, s, p)  # noqa: E731
            library = lambda: F.conv2d(x, w, stride=s,  # noqa: E731
                                       padding=p)
            sw, sx = s_w.reshape(-1), s_x.reshape(1, 1)
        parts["_int_mm"] = lambda: Q.int_mm(a, b)
        parts["rescale"] = lambda: (acc.float() * sx * sw).to(x.dtype)
        ms = {k: cuda_ms(f) for k, f in parts.items()}
        whole_ms, lib_ms = cuda_ms(whole), cuda_ms(library)
        print(f"    ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; the W8A8 op {whole_ms:.3f} against bf16 "
              f"{'cuBLAS' if qk == 'dense' else 'cuDNN'} {lib_ms:.3f} "
              f"(_int_mm {ops / ms['_int_mm'] / 1e9:.1f} TOP/s, bf16 "
              f"{ops / lib_ms / 1e9:.1f} TFLOP/s) [{card}]")
        del a, b, acc, q_x, q_w, parts
    del largest
    torch.cuda.empty_cache()

    # (3) the launches the quantize passes add to a teacher call
    kernels = {}
    for mode in ("bf16", "int8_teacher"):
        tr.apply_int8(cfgs[mode], trainer.teacher)
        kernels[mode] = int8_kernel_count(
            torch, lambda: teacher_call(torch, trainer, lat, t_call, d))
    print(f"  CUDA kernels a teacher call launches: bf16 {kernels['bf16']}, "
          f"int8_teacher {kernels['int8_teacher']} (+"
          f"{kernels['int8_teacher'] - kernels['bf16']} for "
          f"{sum(calls.values())} quantized calls)")

    # (4) SDS steps, the three modes in turns
    ts = trainer.t_schedule(1000).tolist()[200:204]
    times = {m: [] for m, _, _ in INT8_MODES}
    peaks = {m: 0.0 for m, _, _ in INT8_MODES}
    for r, t in enumerate(ts):
        for mode, _, _ in INT8_MODES:
            tr.apply_int8(cfgs[mode], trainer.teacher)
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            with census() as c:
                a = time.perf_counter()
                params, loss, gnorm, fisher, grid = trainer.step(t)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - a) * 1e3
            got = hold_to_census(c, f"{mode} step {r}", failures)
            for k in launches:
                launches[k] += got[k]
            peaks[mode] = max(peaks[mode],
                              torch.cuda.max_memory_allocated() / 2 ** 30)
            finite = all(bool(torch.isfinite(v).all())
                         for v in (loss, gnorm, fisher, grid))
            print(f"  {mode} step {r} t={t}: loss {float(loss):.6g} "
                  f"grad_norm {float(gnorm):.6g} {ms:.1f} ms")
            if not finite:
                failures.append(f"int8 path {mode} step: non-finite output")
            if r:
                times[mode].append(ms)
    for mode, _, _ in INT8_MODES:
        v = sorted(times[mode])
        print(f"  SDS step {mode}: median {v[len(v) // 2]:.1f} ms (timed "
              f"{', '.join(f'{m:.1f}' for m in v)}), peak memory "
              f"{peaks[mode]:.2f} GiB [{card}]")

    # (5) the v-prediction against bf16, and a generate step
    euler = sch.EulerAncestral(trainer.acp, prediction_type="v_prediction",
                               timestep_spacing="trailing")
    g_ts, sigmas = euler.timesteps_and_sigmas(28)
    step_noise = torch.randn(trainer.latent_shape(), device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed + 9))
    v, gen_ms = {}, {}
    for mode, _, _ in INT8_MODES:
        tr.apply_int8(cfgs[mode], trainer.teacher)
        v[mode] = teacher_call(torch, trainer, lat, t_call, d).float()

        def gen_step():
            x = d["noise"] * sigmas[0]
            vp = teacher_call(torch, trainer, x, g_ts[0], d,
                              scale_input=lambda y: euler.scale_model_input(
                                  y, sigmas[0]))
            return euler.step(vp, 0, x, sigmas, step_noise)

        gen_ms[mode] = cuda_ms(gen_step, reps=3, warmup=1)
    for mode in ("int8_controlnet", "int8_teacher"):
        print(f"  v-prediction {mode} against bf16: relative Frobenius "
              f"{rel_fro(v[mode], v['bf16']):.4f}, max abs "
              f"{float((v[mode] - v['bf16']).abs().max()):.4f} (max |v| "
              f"{float(v['bf16'].abs().max()):.4f}; random towers, not "
              "gated)")
    print("  generate step (Euler loop body, t=%d): " % int(g_ts[0])
          + ", ".join(f"{m} {gen_ms[m]:.1f} ms" for m in gen_ms)
          + f" [{card}]")
    tr.apply_int8(cfgs["bf16"], trainer.teacher)
    secs = time.perf_counter() - t_phase
    print(f"  int8 path {secs:.1f} s")
    return launches, secs


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


def hold_to_census(census, label, failures, out=print):
    """Report (through `out`) the launches counted since the last reset and
    hold K3, K4, K6 and gn_bwd to `census`, the calls of the same run that
    route to them. Returns the launches by kernel."""
    from contexture_nerf_tpu_torch.ops import _build

    got = dict(_build.launch_counts)
    bad = census.unmatched(got)
    out(f"  {label}: launches {json.dumps(got)} "
        + (f"!= census {json.dumps(bad)} (launched, census)" if bad
           else "= census"))
    if bad:
        failures.append(f"{label}: launches != census {bad}")
    return got


def counted(torch, fn, label, launches, failures, shapes=None):
    """Run fn() under the census with the launch counts set to 0 just
    before, timed on the host clock with the card synchronised (the
    census's hooks included); hold the launches to the census
    (`hold_to_census`) and add them to `launches`, and the launches by call
    sizes to the Counter `shapes` where given. Returns (result,
    seconds)."""
    from contexture_nerf_tpu_torch.core import profiler
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools.launches import census

    profiler.GLOBAL_TIMINGS = profiler.Timings()  # this run's timings
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with census() as c:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    got = hold_to_census(c, label, failures)
    for k in launches:
        launches[k] += got[k]
    if shapes is not None:
        shapes.update(_build.launch_shapes)
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
    its launches held to its census, and their new K5 and K1
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
    argv = paint_argv(seed, exp_root)
    exp = exp_root / "spot_quick"
    torch.cuda.reset_peak_memory_stats()
    run, secs = counted(torch, lambda: run_contexture.main(argv),
                        "CLI paint run", launches, failures)
    n_frames = run.cfg.log.full_eval_size
    metrics, timings = check_paint_outputs(torch, exp, seed, n_frames,
                                           failures)
    first = {k: v.detach().clone() for k, v in run.mlp.state_dict().items()}
    reference = {"mlp": {k: v.cpu() for k, v in first.items()},
                 "metrics": (metrics or [None])[-1]}
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
        "CLI resumed run", launches, failures)
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

    vc, vc_s = counted(torch, lambda: float(ct._view_consistency_metric()),
                       "view-consistency metric (first call)", launches,
                       failures)
    vc_ms = cuda_ms(lambda: ct._view_consistency_metric(), reps=5)
    _, eval_s = counted(torch, ct.full_eval,
                        f"full_eval ({cfg.log.full_eval_size} frames at "
                        f"{cfg.render.eval_grid_size}^2, texture "
                        f"{cfg.guide.texture_resolution}^2)", launches,
                        failures)
    summ = profiler.GLOBAL_TIMINGS.summary()
    atlas, _ = counted(torch, lambda: mm.get_texture_map_only_valid_areas(
        mlp), "UV-space atlas", launches, failures)
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
    return launches, reference


def paint_argv(seed, exp_root):
    """The paint path's CLI arguments: spot_quick_test.yaml on
    shapes/sphere.obj, checkpoints every 5 iterations."""
    return [f"--config_path={ROOT / 'configs/text_guided/spot_quick_test.yaml'}",
            f"--guide.shape_path={ROOT / 'shapes' / 'sphere.obj'}",
            f"--log.exp_root={exp_root}", "--optim.checkpoint_interval=5",
            f"--optim.seed={seed}"]


class HostPeakRSS:
    """The process's peak resident set (GiB) while the block runs,
    sampled from /proc/self/statm every `every` seconds on a thread."""

    def __init__(self, every=0.002):
        import os
        import threading

        self.every, self.peak = every, 0.0
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _read(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 2 ** 30

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self._read())
            self._stop.wait(self.every)

    def __enter__(self):
        self.start = self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._read())


def drop_from_page_cache(root):
    """fsync every file under root and ask the kernel to drop its pages
    from the page cache (posix_fadvise DONTNEED, no privileges needed), so
    that a load reads the disk and not what the write left in memory."""
    import os

    for path in sorted(Path(root).rglob("*")):
        if path.is_file():
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def snapshot_towers(teacher, diffusion):
    """The ten towers the snapshot path writes, by where they go."""
    return {"zero123plus/unet": teacher.unet,
            "zero123plus/vae (encoder)": teacher.vae_encoder,
            "zero123plus/text_encoder": teacher.text_encoder,
            "zero123plus/vision_encoder": teacher.vision_encoder,
            "controlnet": teacher.controlnet,
            "sd2-depth/unet": diffusion.unet,
            "sd2-depth/vae (encoder)": diffusion.vae_encoder,
            "sd2-depth/vae (decoder)": diffusion.vae_decoder,
            "sd2-depth/text_encoder": diffusion.text_encoder,
            "sd2-inpaint/unet": diffusion.inpaint_unet}


def snapshot_path(torch, seed, reference, failures):
    """The paint path's first CLI run again, from towers on disk: the
    full-width seeded towers that `build_models` draws for that run (same
    seed) are written under build/snapshots/ in the diffusers layout
    (contexture_nerf_tpu_torch/tools/synth_snapshot.py: a Zero123++
    snapshot, a standalone ControlNet, an SD2-depth snapshot and an
    inpaint snapshot, F32, no tokenizer/), dropped from the page cache, and
    the CLI runs with guide.diffusion_name, inpaint_model_path,
    zero123plus_path and controlnet_path pointing there. Every loaded
    tower must equal the written one bit for bit, the launches their
    census, the final MLP parameters and the last metrics entry (less its
    wall time) the random-tower run's (`reference`, from paint_path; run
    here first when None) bit for bit, and the outputs must pass
    check_paint_outputs. The directory is deleted at the end. Returns the
    launches of the runs made here."""
    import gc
    import resource
    import shutil

    from contexture_nerf_tpu_torch import run_contexture
    from contexture_nerf_tpu_torch.core.config import load_config
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools import synth_snapshot as synth
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    launches = {k: 0 for k in _build.launch_counts}
    exp_root = ROOT / "build" / "snapshot_path"
    shutil.rmtree(exp_root, ignore_errors=True)
    argv = paint_argv(seed, exp_root)
    if reference is None:
        run, secs = counted(torch, lambda: run_contexture.main(argv),
                            "CLI paint run (random towers)", launches,
                            failures)
        metrics = json.loads((exp_root / "spot_quick" / "metrics.json")
                             .read_text())
        reference = {"mlp": {k: v.detach().cpu() for k, v in
                             run.mlp.state_dict().items()},
                     "metrics": metrics[-1]}
        print(f"  random-tower CLI run {secs:.1f} s")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(exp_root, ignore_errors=True)

    snap = ROOT / "build" / "snapshots"
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    _, teacher, mlp, diffusion, _ = tr.build_models(load_config(argv),
                                                    device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    del mlp
    towers = snapshot_towers(teacher, diffusion)
    counts = {k: sum(p.numel() for p in m.parameters())
              for k, m in towers.items()}
    need = 4 * sum(counts.values())
    snap.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(snap.parent).free
    print(f"  towers drawn in {draw_s:.1f} s: "
          + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in counts.items())
          + f"; {sum(counts.values()) / 1e6:.1f} M parameters, "
          f"{need / 1e9:.2f} GB at F32; {free / 1e9:.1f} GB free under "
          f"{snap.parent}")
    if free < need + 2 ** 30:
        failures.append(f"snapshot path: {free / 1e9:.1f} GB free under "
                        f"{snap.parent}, the snapshots need "
                        f"{need / 1e9:.2f} GB (+1 GiB)")
        return launches
    try:
        rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        written, write_s = {}, {}
        for name, fn, model in (
                ("zero123plus", synth.write_zero123plus_snapshot, teacher),
                ("controlnet", synth.write_controlnet_snapshot, teacher),
                ("sd2-depth", synth.write_sd_snapshot, diffusion),
                ("sd2-inpaint", synth.write_inpaint_snapshot, diffusion)):
            t0 = time.perf_counter()
            written[name] = fn(snap / name, model)
            write_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drop_from_page_cache(snap)
        sync_s = time.perf_counter() - t0
        total = sum(written.values())
        print(f"  written {total / 1e9:.3f} GB in {sum(write_s.values()):.1f}"
              f" s ({total / 1e9 / sum(write_s.values()):.2f} GB/s; "
              + ", ".join(f"{k} {written[k] / 1e9:.3f} GB {write_s[k]:.1f} s"
                          for k in written)
              + f"), then fsync and page-cache drop {sync_s:.1f} s [{card}]")
        written_sd = {k: m.state_dict() for k, m in towers.items()}
        del teacher, diffusion, towers
        gc.collect()
        torch.cuda.empty_cache()

        args = argv + [f"--guide.diffusion_name={snap / 'sd2-depth'}",
                       f"--guide.inpaint_model_path={snap / 'sd2-inpaint'}",
                       f"--guide.zero123plus_path={snap / 'zero123plus'}",
                       f"--guide.controlnet_path={snap / 'controlnet'}"]
        torch.cuda.reset_peak_memory_stats()
        with HostPeakRSS() as rss:
            run, secs = counted(torch, lambda: run_contexture.main(args),
                                "CLI paint run from snapshots", launches,
                                failures)
        card_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rss_max = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        loaded = {f"sd2/{k}": v for k, v in run.diffusion.loaded.items()}
        loaded.update({f"zero123plus/{k}": v
                       for k, v in run.teacher.loaded.items()})
        for k, v in loaded.items():
            print(f"    load {k}: {v['bytes'] / 1e9:.3f} GB in "
                  f"{v['seconds']:.2f} s, {v['bytes'] / 1e9 / v['seconds']:.2f}"
                  f" GB/s [{card}]")
        n_bytes = sum(v["bytes"] for v in loaded.values())
        n_secs = sum(v["seconds"] for v in loaded.values())
        print(f"  loaded {len(loaded)} towers, {n_bytes / 1e9:.3f} GB in "
              f"{n_secs:.1f} s ({n_bytes / 1e9 / n_secs:.2f} GB/s); CLI run "
              f"{secs:.1f} s; card peak memory {card_peak:.2f} GiB; host "
              f"RSS {rss.start:.2f} GiB at the run's start, peak "
              f"{rss.peak:.2f} GiB over it (sampled every 2 ms; the "
              f"process's lifetime peak {rss_max / 2 ** 20:.2f} GiB, "
              f"{rss_before / 2 ** 20:.2f} before the phase) [{card}]")
        if len(loaded) != len(written_sd) or n_bytes != need:
            failures.append(f"snapshot path: {len(loaded)} towers and "
                            f"{n_bytes} bytes loaded, not "
                            f"{len(written_sd)} and {need}")

        differ = []
        for k, m in snapshot_towers(run.teacher, run.diffusion).items():
            got = m.state_dict()
            if set(got) != set(written_sd[k]) or not all(
                    torch.equal(got[n], t) for n, t in written_sd[k].items()):
                differ.append(k)
        print(f"  loaded towers equal the written ones bit for bit: "
              f"{not differ}{' (' + ', '.join(differ) + ' differ)' if differ else ''}")
        if differ:
            failures.append(f"snapshot path: loaded towers differ: {differ}")
        del written_sd

        exp = exp_root / "spot_quick"
        metrics, _ = check_paint_outputs(torch, exp, seed,
                                         run.cfg.log.full_eval_size, failures)
        got = {k: v.detach().cpu() for k, v in run.mlp.state_dict().items()}
        ref = reference["mlp"]
        mlp_same = set(got) == set(ref) and all(torch.equal(got[k], ref[k])
                                                for k in ref)
        last, ref_last = (metrics or [None])[-1], reference["metrics"]
        keys = sorted(set(ref_last or {}) - {"elapsed_s"})
        m_same = bool(last) and bool(ref_last) and all(
            last[k] == ref_last[k] for k in keys)
        print(f"  against the random-tower run: final MLP parameters "
              f"bit-identical {mlp_same}; last metrics entry "
              f"({', '.join(keys)}) bit-identical {m_same}")
        if not mlp_same:
            worst = max((float((got[k].float() - ref[k].float()).abs().max()),
                         k) for k in ref if k in got)
            print(f"    first differing MLP parameter by size: {worst[1]} "
                  f"max |diff| {worst[0]:.3e}")
            failures.append("snapshot path: final MLP parameters differ "
                            "from the random-tower run")
        if not m_same:
            print(f"    random towers {ref_last}\n    from disk     {last}")
            failures.append("snapshot path: last metrics entry differs "
                            "from the random-tower run")
        # one tower loaded again, from the disk and from the page cache
        from contexture_nerf_tpu_torch.diffusion import weights as W

        unet, path = run.diffusion.unet, snap / "sd2-depth" / "unet"
        for label in ("page cache dropped", "page cache warm"):
            if label == "page cache dropped":
                drop_from_page_cache(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = W.load_checkpoint_(unet, str(path), W.convert_unet,
                                   unet.config)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"    sd2-depth/unet loaded again, {label}: "
                  f"{n / 1e9:.3f} GB in {dt:.2f} s, {n / 1e9 / dt:.2f} GB/s "
                  f"[{card}]")
        del run, unet
    finally:
        shutil.rmtree(snap, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  snapshot path {time.perf_counter() - t_phase:.1f} s "
          f"(build/snapshots/ deleted)")
    return launches


# the mesh path: a mesh a user brings (no UVs), at 100,000 faces
MESH_LAT, MESH_LON = 251, 200  # numpy_uv_sphere: 2 x 200 x 250 faces
MESH_STEM = "mesh_path_sphere"


def write_uvless_obj(path, verts, faces):
    """An OBJ of v and f lines only, as a mesh without UVs comes."""
    import numpy as np

    with open(path, "w") as fh:
        np.savetxt(fh, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(fh, faces + 1, fmt="f %d %d %d")


OFF_STEM = MESH_STEM + "_off"


def write_off(path, verts, faces):
    """An OFF file of the triangles in their order, the vertices written as
    write_uvless_obj writes them."""
    import numpy as np

    with open(path, "w") as fh:
        fh.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
        np.savetxt(fh, verts, fmt="%.6f %.6f %.6f")
        np.savetxt(fh, faces, fmt="3 %d %d %d")


def kaolin_entries(torch, seed, sphere, launches, shapes, failures, card):
    """The kaolin-compatible geometry entries on the card. raster/
    rasterize.py `rasterize` with backend=None on CUDA tensors (K5, one
    launch a call) on the torus's 7 views and on the sphere's front view at
    the default 1200^2, each equal bit for bit to backend="plain" on the
    same tensors (face_idx and the interpolated UVs); a planted fault, the
    plain call on the UV features of a face order rolled by one, must
    differ. `Renderer.render_multiple_view_texture` on the torus (a random
    1024^2 texture, white background) equal bit for bit to render_geometry
    + render_texture_with_cache, and with the cache given to itself and
    without a rasterization; the same planted fault on its UV attributes
    must differ."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.models import textured_mesh as tmm
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.raster.rasterize import rasterize
    from contexture_nerf_tpu_torch.training import trainer as tr

    dev = torch.device("cuda")
    cfg = config_from_dict({"guide": {
        "shape_path": str(ROOT / "shapes" / "torus.obj")}})
    torus = tmm.TexturedMeshModel(
        cfg.guide, render_grid_size=cfg.render.train_grid_size,
        texture_resolution=cfg.guide.texture_resolution, device=dev)
    res = cfg.render.train_grid_size
    th, ph, r = tr.view_angles(cfg.render)
    ok = True
    for label, mm, n in (("the torus's 7 views", torus, 7),
                         ("the sphere's front view", sphere, 1)):
        _, fvc, fvi, _ = mm.project(th[:n], ph[:n], r[:n])
        fvz = fvc[..., 2].contiguous()
        uv = mm.face_attributes.expand(n, -1, -1, -1)
        (img, idx), secs = counted(
            torch, lambda: rasterize(res, res, fvz, fvi, uv),
            f"rasterize (backend=None) on {label} ({n}x{res}^2, "
            f"F={fvz.shape[1]})", launches, failures, shapes)
        p_img, p_idx = rasterize(res, res, fvz, fvi, uv, backend="plain",
                                 face_chunk=256)
        same = torch.equal(img, p_img) and torch.equal(idx, p_idx)
        line = (f"  rasterize on {label}: {1e3 * secs:.1f} ms, face_idx and "
                f"UVs bit-identical to backend=\"plain\" {same}, "
                f"{float((idx >= 0).float().mean()):.4f} of pixels covered")
        ok &= same
        if n > 1:  # the planted fault, on the torus (plain on the sphere
            # takes ~11 s a call)
            rolled, _ = rasterize(res, res, fvz, fvi, uv.roll(1, dims=1),
                                  backend="plain", face_chunk=256)
            caught = not torch.equal(img, rolled)
            line += (f"; planted rolled face order "
                     f"{'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                failures.append("rasterize's check passes a rolled face "
                                "order")
        print(line + f" [{card}]")
        del img, idx, p_img, p_idx, fvc, fvi, fvz
    # the renderer's entry on the torus
    rnd = torus.renderer
    uv = torus.face_attributes.expand(7, -1, -1, -1)
    tex = torch.rand((1, 3) + (cfg.guide.texture_resolution,) * 2,
                     generator=torch.Generator(device=dev).manual_seed(
                         seed + 12), device=dev)

    def render(attr, **kw):
        return rnd.render_multiple_view_texture(
            torus.verts, torus.faces, attr, tex, th, ph, r,
            look_at_height=torus.dy, background_type="white", **kw)

    got, secs = counted(torch, lambda: render(uv),
                        f"render_multiple_view_texture on the torus "
                        f"(7x{res}^2)", launches, failures, shapes)
    want, _ = counted(torch, lambda: rnd.render_texture_with_cache(
        rnd.render_geometry(torus.verts, torus.faces, uv, th, ph, r,
                            look_at_height=torus.dy), tex, "white"),
        "render_geometry + render_texture_with_cache on the torus", launches,
        failures, shapes)
    cached, _ = counted(torch, lambda: render(uv, render_cache=got[4]),
                        "render_multiple_view_texture, the cache given",
                        launches, failures, shapes)
    same_cached = all(torch.equal(a, b) for a, b in zip(got[:4], cached[:4])
                      ) and _build.launch_counts["raster"] == 0
    with plain_paths(torch, k1=False):
        rolled = render(uv.roll(1, dims=1))
    same = all(torch.equal(a, b) for a, b in zip(got[:4], want))
    caught = not torch.equal(got[0], rolled[0])
    finite = all(bool(torch.isfinite(x).all()) for x in got[:4])
    print(f"  render_multiple_view_texture on the torus: {1e3 * secs:.1f} ms;"
          f" image, mask, depth, normals bit-identical to render_geometry + "
          f"render_texture_with_cache {same}, with the cache given (no "
          f"rasterization) {same_cached}, finite {finite}; planted rolled "
          f"face order {'caught' if caught else 'NOT CAUGHT'} [{card}]")
    ok &= same and same_cached and finite
    if not caught:
        failures.append("render_multiple_view_texture's check passes a "
                        "rolled face order")
    if not ok:
        failures.append("the kaolin-compatible entries differ from their "
                        "plain or composed versions")


def off_cli_runs(torch, seed, obj, verts, faces, unwraps, launches, shapes,
                 failures, card):
    """(e) An OFF shape: the mesh path's sphere written as an OFF under a
    stem of its own, the OBJ's triangles in the OBJ's order, which
    Mesh.load must read to the OBJ's arrays; then the CLI at full width on
    the OBJ and on the OFF (optim.sds_iterations=2, a 2-frame eval), each
    unwrapping into its own cache/<stem>/ (one unwrap each: the OFF run
    does not read the OBJ's atlas), each run's launches held to its
    census. The two runs must give the same atlas, MLP,
    losses and files (the albedo PNG, the turntable, the atlas PNG, the
    logged images) bit for bit."""
    import gc
    import shutil

    import numpy as np

    from contexture_nerf_tpu_torch import run_contexture
    from contexture_nerf_tpu_torch.models.mesh import Mesh

    off = obj.with_name(f"{OFF_STEM}.off")
    write_off(off, verts, faces)
    a, b = Mesh.load(str(obj)), Mesh.load(str(off))
    keys = ("vertices", "faces", "normals", "face_area")
    loaded = (a.vt is None and b.vt is None and all(
        getattr(a, k).dtype == getattr(b, k).dtype
        and np.array_equal(getattr(a, k), getattr(b, k)) for k in keys))
    print(f"  (e) {off.name} ({off.stat().st_size / 1e6:.1f} MB): Mesh.load "
          f"gives the OBJ's vertices, faces, normals and areas {loaded}")
    if not loaded:
        failures.append("mesh path: the OFF's arrays differ from the OBJ's")
    del a, b
    exp_root = obj.parent / "cli"
    runs = {}
    for ext, shape in (("obj", obj), ("off", off)):
        cache = Path("cache") / shape.stem
        shutil.rmtree(cache, ignore_errors=True)
        n = len(unwraps)
        argv = [f"--guide.shape_path={shape}",
                "--guide.text=a photo of a dairy cow",
                f"--log.exp_root={exp_root}", f"--log.exp_name={shape.stem}",
                f"--optim.seed={seed}", "--optim.sds_iterations=2",
                "--log.full_eval_size=2"]
        run, secs = counted(torch, lambda: run_contexture.main(argv),
                            f"(e) the CLI on {shape.name}", launches,
                            failures, shapes)
        exp = exp_root / shape.stem
        runs[ext] = {
            "secs": secs, "unwraps": len(unwraps) - n,
            "cache": sorted(p.name for p in cache.iterdir()),
            "vt": run.mesh_model.vt, "ft": run.mesh_model.ft,
            "mlp": {k: v.detach().cpu() for k, v in run.mlp.state_dict(
            ).items()},
            "metrics": [{k: v for k, v in e.items() if k != "elapsed_s"}
                        for e in json.loads((exp / "metrics.json"
                                             ).read_text())],
            "files": {str(p.relative_to(exp)): p.read_bytes() for d in (
                "results", "mesh", "vis") for p in sorted((exp / d).rglob(
                    "*")) if p.is_file()}}
        del run
        gc.collect()
        torch.cuda.empty_cache()
    o, f = runs["obj"], runs["off"]
    atlas = np.array_equal(o["vt"], f["vt"]) and np.array_equal(o["ft"],
                                                                f["ft"])
    mlp = all(torch.equal(o["mlp"][k], f["mlp"][k]) for k in o["mlp"])
    losses = bool(o["metrics"]) and o["metrics"] == f["metrics"]
    files = bool(o["files"]) and o["files"] == f["files"]
    own = o["unwraps"] == f["unwraps"] == 1 and bool(f["cache"])
    print(f"  (e) the CLI on the OBJ {o['secs']:.1f} s, on the OFF "
          f"{f['secs']:.1f} s (2 SDS iterations, a 2-frame eval, each with "
          f"its unwrap: {o['unwraps']} and {f['unwraps']}, caches "
          f"cache/{obj.stem}/{o['cache']} and cache/{off.stem}/{f['cache']}"
          f"); bit for bit: atlas {atlas}, MLP {mlp}, metrics {losses} "
          f"(sds_loss {[e.get('sds_loss') for e in f['metrics']]}), "
          f"{len(f['files'])} files {files} ({', '.join(sorted(f['files']))})"
          f" [{card}]")
    if not (atlas and mlp and losses and files and own):
        failures.append("mesh path: the CLI's OFF run differs from its OBJ "
                        "run")


def native_vs_numpy(unwrap, verts, faces, obj, card, failures):
    """The C++ unwrap (native/objio.py) and the numpy unwrap (`unwrap`,
    textured_mesh.atlas_unwrap with native=False) of one mesh on the host,
    timed, their ratio, and whether atlas_unwrap kept the C++ atlas (no
    chart overlaps itself); the OBJ read by the C++ parser and by the
    numpy parser, timed and held equal."""
    import numpy as np

    from contexture_nerf_tpu_torch.models import mesh as mesh_io
    from contexture_nerf_tpu_torch.models import textured_mesh as tmm
    from contexture_nerf_tpu_torch.native import objio

    objio.build()  # the g++ build is not in the times
    t0 = time.perf_counter()
    vt_n, ft_n = objio.chart_unwrap_native(verts, faces)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    overlaps = tmm._chart_overlaps(vt_n, ft_n)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vt_p, ft_p = unwrap(verts, faces, native=False)
    numpy_s = time.perf_counter() - t0
    same_ft = np.array_equal(ft_n, ft_p)
    print(f"  (a) unwrap of the {faces.shape[0]}-face sphere on the host: "
          f"C++ {native_s:.3f} s (+ the overlap check {check_s:.3f} s), "
          f"numpy {numpy_s:.3f} s, numpy / C++ {numpy_s / native_s:.1f}x "
          f"(with the check {numpy_s / (native_s + check_s):.1f}x); a "
          f"chart overlaps itself: {overlaps}; the same ft {same_ft} "
          f"[{card}]")
    t0 = time.perf_counter()
    got = mesh_io.load_obj(str(obj))
    read_n = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = mesh_io.load_obj(str(obj), native=False)
    read_p = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(got[:2], plain[:2])) \
        and got[2] is None and plain[2] is None
    print(f"  (a) OBJ read of {obj.name} ({obj.stat().st_size / 1e6:.1f} MB):"
          f" C++ {read_n:.3f} s, numpy {read_p:.3f} s, numpy / C++ "
          f"{read_p / read_n:.1f}x, the same arrays {same} [{card}]")
    if overlaps or not same:
        failures.append("mesh path: the native unwrap or OBJ reader")


def mesh_path(torch, seed, teacher, shape_recs, failures):
    """A mesh a user brings, at full width: a UV sphere of 100,000 faces
    written as an OBJ without UVs. (a) its atlas unwrapped on the host
    (timed), then read from cache/<stem>/ (timed; nothing unwrapped); the
    atlas in [0, 1] with _overlap_frac(G=256) < 0.02; K5 at prepare_sds's
    two shapes on the mesh and in UV space held to the plain version; the
    kaolin-compatible entries (`kaolin_entries`). (b)
    the 300-step fit to an image written here, whose MSE must fall (K1 and
    K2 at its and the lattice's point counts are held in mlp_phases). (c)
    build_sds_trainer on the mesh with exact_lattice_render and that image
    as guide.initial_texture: one warm-up and three timed steps, launches
    held to their census, peak memory; the same steps again from the same
    state, held to the first at a stated tolerance, and twice with a
    planted fault that must miss it. (d) the default path with
    guide.reference_texture the current texture map as PNG: the change
    mask is empty and a step leaves the MLP as it was; a planted mask of
    ones changes it. (e) the sphere as an OFF through the CLI beside its
    OBJ (`off_cli_runs`). Every run of the path holds its launches to its
    census; shape_recs, keyed by launch sizes as
    _build.launch_shapes keys them, get this path's launches at theirs.
    Returns the launches by kernel."""
    import copy
    import gc
    import shutil
    from collections import Counter

    import numpy as np

    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.diffusion.sd_depth import \
        StableDiffusionDepth
    from contexture_nerf_tpu_torch.models import textured_mesh as tmm
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops.image import save_image, tensor2numpy
    from contexture_nerf_tpu_torch.raster import raster_kernel as rk
    from contexture_nerf_tpu_torch.raster.rasterize import rasterize_geometry
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {k: 0 for k in _build.launch_counts}
    shapes = Counter()  # the path's launches by call sizes
    work = ROOT / "build" / "mesh_path"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    obj = work / f"{MESH_STEM}.obj"
    v, f = numpy_uv_sphere(MESH_LAT, MESH_LON)
    write_uvless_obj(obj, v, f)
    F = f.shape[0]
    text = "a photo of a dairy cow"

    def cfg_of(optim=None, **guide):
        return config_from_dict({
            "optim": dict({"seed": seed}, **(optim or {})),
            "guide": dict({"text": text, "shape_path": str(obj)}, **guide)})

    cfg = cfg_of()
    cache = Path("cache") / MESH_STEM  # where build_models keeps the atlas
    shutil.rmtree(cache, ignore_errors=True)
    unwraps = []
    real_unwrap = tmm.atlas_unwrap

    def timed_unwrap(*a, **k):
        t0 = time.perf_counter()
        out = real_unwrap(*a, **k)
        unwraps.append(time.perf_counter() - t0)
        return out

    def model():
        t0 = time.perf_counter()
        mm = tmm.TexturedMeshModel(
            cfg.guide, render_grid_size=cfg.render.train_grid_size,
            texture_resolution=cfg.guide.texture_resolution,
            cache_path=cache, compute_dtype=teacher.dtype, device=dev)
        return mm, time.perf_counter() - t0

    tmm.atlas_unwrap = timed_unwrap
    try:
        # (a) the atlas
        mm, cold_s = model()
        again, warm_s = model()
        vt, ft = mm.vt, mm.ft
        t0 = time.perf_counter()
        overlap = tmm._overlap_frac(vt, ft, G=256)
        overlap_s = time.perf_counter() - t0
        charts = int(tmm._charts_from_ft(ft).max()) + 1
        in01 = bool(vt.min() >= 0.0 and vt.max() <= 1.0)
        same = np.array_equal(again.vt, vt) and np.array_equal(again.ft, ft)
        files = sorted(p.name for p in cache.iterdir())
        print(f"  (a) {obj.name}: {F} faces, {v.shape[0]} vertices, no UVs; "
              f"atlas_unwrap {unwraps[0]:.2f} s on the host "
              f"({1e3 * unwraps[0] / F:.4f} ms a face), the model built "
              f"in {cold_s:.2f} s; {vt.shape[0]} UV vertices in {charts} "
              f"charts, in [0, 1] {in01}, overlap_frac(G=256) "
              f"{overlap:.5f} (limit 0.02; {overlap_s:.1f} s); cache "
              f"{files}; the second build {warm_s:.2f} s, unwraps "
              f"{len(unwraps)}, the same atlas {same} [{card}]")
        if not (in01 and overlap < 0.02 and same and len(unwraps) == 1):
            failures.append("mesh path: the atlas or its cache")
        del again
        # the real unwrap: the timed one counts the model's unwraps
        native_vs_numpy(real_unwrap, mm.mesh.vertices, mm.mesh.faces, obj,
                        card, failures)

        th, ph, r = tr.view_angles(cfg.render)
        _, fvc, fvi, _ = mm.project(th, ph, r)
        fvz = fvc[..., 2].contiguous()
        res = cfg.render.train_grid_size
        ok_all = True

        def plain_timed(cz, ci, H):
            """The plain version a view at a time, and its event ms."""
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs = [rasterize_geometry(cz[i:i + 1], ci[i:i + 1], H, H,
                                       face_chunk=256)
                    for i in range(cz.shape[0])]
            t1.record()
            torch.cuda.synchronize()
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]), t0.elapsed_time(t1))

        # prepare_sds's two launches on the mesh: the bootstrap's front pose
        # and the 7 views
        for label, cz, ci in (("the front pose", fvz[:1], fvi[:1]),
                              ("the 7 views", fvz, fvi)):
            B = cz.shape[0]
            idx, bary = rk.rasterize_geometry_kernel(cz, ci, res, res)
            p_idx, p_bary, pms = plain_timed(cz, ci, res)
            a = rk.raster_agreement(idx, bary, p_idx, p_bary, cz)
            exact = torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
            ok = rk.agreement_ok(a)
            ok_all &= ok
            del idx, bary, p_idx, p_bary
            ms, dtimes = raster_times(torch, rk.rasterize_geometry_kernel,
                                      cz, ci, res, res)
            pairs = pixel_face_pairs(torch, ci, res, res)
            nbytes = B * (res * res * 16 + F * 36)
            shape_recs[("raster", B, res, res, F)].add(
                a["bary_err"], ms, pms, 20.0 * pairs, nbytes)
            print(f"  K5 unwrapped sphere, {label} ({B}x{res}^2, F={F}): "
                  f"face_idx agree {a['agree']:.6f}, {a['unexplained']} "
                  f"unexplained, bary max err {a['bary_err']:.3e}, "
                  f"bit-identical to plain {exact} {'ok' if ok else 'MISS'}; "
                  f"{times_line(ms, dtimes)}; plain_ms {pms:.2f}; bound "
                  f"{bound(20.0 * pairs, nbytes, H100_FP32_FLOPS)[0]:.4f} ms "
                  f"[{card}]")

        tres = cfg.guide.texture_resolution
        fvi_uv = (mm.face_attributes * 2.0 - 1.0).contiguous()
        fvz_uv = torch.ones(fvi_uv.shape[:-1], device=dev)
        idx, bary = rk.rasterize_geometry_kernel(fvz_uv, fvi_uv, tres, tres)
        p_idx, p_bary = rasterize_geometry(fvz_uv, fvi_uv, tres, tres,
                                           face_chunk=256)
        same_uv = torch.equal(idx, p_idx) and torch.equal(bary, p_bary)
        a = rk.raster_agreement(idx, bary, p_idx, p_bary, fvz_uv)
        mlp_a = NeRF2D(generator=torch.Generator(device=dev).manual_seed(
            seed + 3), device=dev)
        atlas, _ = counted(torch, lambda: mm.get_texture_map_only_valid_areas(
            mlp_a), "(a) UV-space atlas of the unwrapped sphere", launches,
            failures, shapes)
        with plain_paths(torch, k1=False):
            atlas_p = mm.get_texture_map_only_valid_areas(mlp_a)
        atlas_same = torch.equal(atlas, atlas_p)
        ms_uv, d_uv = raster_times(torch, rk.rasterize_geometry_kernel,
                                   fvz_uv, fvi_uv, tres, tres)
        pms_uv = cuda_ms(lambda: rasterize_geometry(fvz_uv, fvi_uv, tres,
                                                    tres, face_chunk=256),
                         reps=1, warmup=0)
        pairs = pixel_face_pairs(torch, fvi_uv, tres, tres)
        nbytes = tres * tres * 16 + F * 36
        shape_recs[("raster", 1, tres, tres, F)].add(
            a["bary_err"], ms_uv, pms_uv, 20.0 * pairs, nbytes)
        print(f"  K5 UV-space raster of the atlas (1x{tres}^2, every z 1, "
              f"F={F}): bit-identical to plain {same_uv}, "
              f"{float((idx >= 0).float().mean()):.4f} of texels covered; "
              f"the atlas through plain K5 bit-identical {atlas_same}; "
              f"{times_line(ms_uv, d_uv)}; plain_ms {pms_uv:.2f} [{card}]")
        if not (ok_all and same_uv and atlas_same):
            failures.append("mesh path: K5 on the unwrapped sphere")
        del idx, bary, p_idx, p_bary, atlas, atlas_p, fvc, fvi, fvz
        torch.cuda.empty_cache()
        kaolin_entries(torch, seed, mm, launches, shapes, failures, card)
        torch.cuda.empty_cache()

        # (b) the fit to an image
        img = np.random.default_rng(seed).uniform(0.0, 1.0, (4, 4, 3))
        img = np.kron(img, np.ones((64, 64, 1)))  # 4x4 blocks of colour
        save_image((img * 255).astype(np.uint8), work / "initial.png")
        image = tr.load_texture_image(work / "initial.png",
                                      cfg.guide.texture_resolution)
        mlp_b = NeRF2D(generator=torch.Generator(device=dev).manual_seed(
            seed + 4), device=dev)
        losses, fit_s = counted(
            torch, lambda: mm.fit_texture_to_image(
                mlp_b, image, steps=tr.FIT_STEPS,
                generator=torch.Generator(device=dev).manual_seed(seed)),
            f"(b) fit_texture_to_image ({tr.FIT_STEPS} "
            "steps of 4,096 points)", launches, failures, shapes)
        losses = losses.cpu()
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        print(f"  (b) the fit: MSE {float(losses[0]):.5f} -> "
              f"{float(losses[-1]):.5f} (first 10 steps' mean {first:.5f}, "
              f"last 10 {last:.5f}) in {fit_s:.2f} s "
              f"({1e3 * fit_s / tr.FIT_STEPS:.2f} ms a step) [{card}]")
        if not (bool(torch.isfinite(losses).all()) and last < 0.5 * first):
            failures.append("mesh path: the fit's MSE did not fall")
        del mlp_b, mlp_a

        # (c) exact_lattice_render on the sphere, the fit in build_models
        sd = StableDiffusionDepth(device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        cfg_c = cfg_of({"exact_lattice_render": True},
                       initial_texture=str(work / "initial.png"))

        torch.cuda.reset_peak_memory_stats()
        (trainer, setup), build_s = counted(
            torch, lambda: tr.build_sds_trainer(cfg_c, device="cuda",
                                                teacher=teacher,
                                                diffusion=sd),
            "(c) build_sds_trainer, exact_lattice_render + initial_texture",
            launches, failures, shapes)
        build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  (c) built in {build_s:.1f} s (the atlas from the cache: "
              f"unwraps {len(unwraps)}); exact {trainer.exact}, "
              f"local_sds_grad {trainer.local_grad}; peak memory "
              f"{build_peak:.2f} GiB")
        if not trainer.exact or trainer.local_grad or len(unwraps) != 1:
            failures.append("mesh path: the exact trainer")
        ts = trainer.t_schedule(1000).tolist()[100:104]
        state = ({k: v.clone() for k, v in trainer.mlp.state_dict().items()},
                 copy.deepcopy(trainer.optimizer.state_dict()),
                 trainer.generator.get_state())
        lr = cfg_c.optim.sds_lr

        def exact_run(label, optimizer=True, generator=True):
            """The steps from `state`; a planted fault leaves the optimizer's
            or the generator's state where the last run left it."""
            trainer.mlp.load_state_dict(state[0])
            if optimizer:
                trainer.optimizer.load_state_dict(copy.deepcopy(state[1]))
            if generator:
                trainer.generator.set_state(state[2])
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for i, t in enumerate(ts):
                (_, loss, _, _, grid), secs = counted(
                    torch, lambda: trainer.step(t),
                    f"(c) exact step {i} of {label}", launches, failures,
                    shapes)
                for key in (K7_FWD_KEY, K7_BWD_KEY):
                    if key in shape_recs:
                        shape_recs[key].d["step_launches"] = \
                            _build.launch_counts[key[0]]
                losses.append(float(loss))
                times.append(1e3 * secs)
                if not (np.isfinite(losses[-1]) and bool(
                        torch.isfinite(grid).all())):
                    failures.append(f"mesh path: exact step {i} of {label} "
                                    "not finite")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            med = sorted(times[1:])[len(times[1:]) // 2]
            print(f"  (c) {label}: exact step losses "
                  + ", ".join(f"{x:.6g}" for x in losses)
                  + f"; ms {', '.join(f'{x:.1f}' for x in times)} (the "
                  f"first a warm-up; median of the timed {med:.1f}); peak "
                  f"memory {peak:.2f} GiB [{card}]")
            return losses, {k: v.detach().clone()
                            for k, v in trainer.mlp.state_dict().items()}

        def within(a, b):
            """Two exact runs from one state: the first step's forward is
            deterministic (K1, K7, the teacher), so its loss is equal; the
            backward is not asked to be (cuDNN's convolution gradients in
            the VAE), so a near-zero gradient may flip Adam's step: 99.9% of
            the parameters within lr of each other, and the later losses
            within 1%. On an H100 two sound runs, with the plain gather's
            atomic backward, kept 0.99986 of the parameters within lr and
            their losses within 2.5e-3 (with K7's backward they were
            bit-identical); with Adam's state not restored 0.86 of them
            stayed within lr, with the generator's 0.47."""
            (l0, p0), (l1, p1) = a, b
            first = l0[0] == l1[0]
            rel = max(abs(x - y) / abs(y) for x, y in zip(l0, l1))
            share = min(float(((p0[k] - p1[k]).abs() <= lr).float().mean())
                        for k in p0)
            bit = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
            ok = first and rel <= 1e-2 and share >= 0.999
            return ok, (f"bit-identical {bit}; first losses equal {first}; "
                        f"losses max rel diff {rel:.3e} (limit 1e-2); share "
                        f"of parameters within lr {share:.6f} (limit 0.999)")

        run0 = exact_run("run 0")
        ok, line = within(run0, exact_run("run 1"))
        print(f"  (c) two runs from one state: {line} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append("mesh path: two exact runs differ beyond the "
                            "tolerance")
        for label, kw in (("the Adam state not restored",
                           {"optimizer": False}),
                          ("the generator not restored",
                           {"generator": False})):
            ok, line = within(run0, exact_run(f"run 0 again, {label}",
                                              **kw))
            print(f"  (c) planted fault, {label}: {line} "
                  f"{'NOT CAUGHT' if ok else 'caught'}")
            if ok:
                failures.append(f"the exact runs' tolerance passes planted "
                                f"fault {label}")
        del trainer, setup, state, run0
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the default path with reference_texture = the current map
        mlp_d = NeRF2D(generator=torch.Generator(device=dev).manual_seed(
            seed + 5), device=dev)
        with torch.no_grad():
            tex, _ = mm.get_texture_map(mlp_d)
        save_image(tensor2numpy(tex[0].permute(1, 2, 0).clamp(0, 1)),
                   work / "reference.png")
        del tex
        cfg_d = cfg_of(reference_texture=str(work / "reference.png"))
        (trainer, setup), _ = counted(
            torch, lambda: tr.build_sds_trainer(cfg_d, device="cuda",
                                                teacher=teacher, mlp=mlp_d,
                                                diffusion=sd),
            "(d) build_sds_trainer, reference_texture", launches, failures,
            shapes)
        change = trainer.mesh_model.edit_change_mask
        pts = setup["edit_mask_pts"]
        empty = (change is not None and pts is not None
                 and float(change.sum()) == 0 and float(pts.abs().sum()) == 0)
        before = {k: v.clone() for k, v in mlp_d.state_dict().items()}
        t = trainer.t_schedule(1000).tolist()[100]
        (_, loss, _, _, _), secs = counted(
            torch, lambda: trainer.step(t),
            "(d) default step, empty change mask", launches, failures, shapes)
        kept = all(torch.equal(before[k], v)
                   for k, v in mlp_d.state_dict().items())
        trainer.edit_mask = torch.ones_like(trainer.edit_mask)  # planted
        (_, loss1, _, _, _), secs1 = counted(
            torch, lambda: trainer.step(t),
            "(d) default step, a planted mask of ones", launches, failures,
            shapes)
        moved = any(not torch.equal(before[k], v)
                    for k, v in mlp_d.state_dict().items())
        print(f"  (d) change mask of the unchanged texture: "
              f"{0 if change is None else int(change.sum())} texels, "
              f"edit_mask_pts sum "
              f"{float('nan') if pts is None else float(pts.sum())}; a step "
              f"(loss {float(loss):.6g}, {1e3 * secs:.1f} ms) left the MLP "
              f"as it was {kept}; with a planted mask of ones (loss "
              f"{float(loss1):.6g}, {1e3 * secs1:.1f} ms) it moved {moved}")
        if not (empty and kept and moved):
            failures.append("mesh path: the reference_texture mask")
        del trainer, setup, sd, mlp_d, mm
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the same sphere as an OFF, through the CLI beside the OBJ
        off_cli_runs(torch, seed, obj, v, f, unwraps, launches, shapes,
                     failures, card)
    finally:
        tmm.atlas_unwrap = real_unwrap
    gc.collect()
    torch.cuda.empty_cache()
    record_launches(shape_recs, shapes, "on the mesh path", failures)
    print(f"  mesh path {time.perf_counter() - t_phase:.1f} s")
    return launches


GEN_STEPS = 28  # check_gt_zero123plus's default, the reference's


def attention_shape_record(torch, args, name):
    """A K3/K4 shape record timed at one real call's inputs: the kernel, the
    plain version and SDPA on the concatenated KV (CUDA events), the bound
    4 B H Sq (Skv + Se) d operations or the bytes of q, k, v, o."""
    import torch.nn.functional as F

    from contexture_nerf_tpu_torch.ops import attention as att

    q, k, v, ek, ev = args
    kk = k if ek is None else torch.cat([k, ek], dim=2)
    vv = v if ev is None else torch.cat([v, ev], dim=2)
    B, H, Sq, _ = q.shape
    rec = Record(name, "contexture_nerf_tpu_torch/csrc/flash_attn.cu",
                 "contexture_nerf_tpu/ops/attention.py:"
                 + ("159" if ek is not None else "140"))
    err = float((att.flash_attention(*args).float()
                 - att.flash_attention_plain(*args).float()).abs().max())
    rec.add(err, cuda_ms(lambda: att.flash_attention(*args)),
            cuda_ms(lambda: att.flash_attention_plain(*args), reps=3),
            4.0 * B * H * Sq * kk.shape[2] * q.shape[3],
            2 * (2 * q.numel() + kk.numel() + vv.numel()),
            lib_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, vv)))
    return rec


def generation_path(torch, seed, models, recs, shape_recs, failures):
    """Ground-truth multiview generation at full width, as its two drivers
    run it. (1) `get_depth_maps_cond_grid.main` on shapes/torus.obj at the
    default config (the 7 views at render.train_grid_size, the 50-step
    SD2-depth paint of the front view), then a second
    `ConTEXTure.paint_viewpoint` of the front pose (the repaint: the median
    fill, the inpaint UNet at 10 < i < 20): both finite in [0, 1] and equal
    outside the object's box. (2) `check_gt_zero123plus.main` on the two
    PNGs: 28 EulerAncestral steps at 960x640 on random full-width towers,
    grid.png and 6 views written, the grid finite in [0, 1], and generate
    again from the same draws bit-identical. (3) generate with use_blending
    and use_inpaint (the mask grid: the 6 views' object masks at the
    latent size; the renders and the masked latents: VAE encodes of the
    condition image tiled 3x2; the SD2 stack's inpaint UNet attached), and
    with use_blending alone at mask 1 (the plain grid, bit for bit) and at
    mask 0 (the decode of the renders, bit for bit). (4) K3/K4 held to
    attention_limit on every kernel-routed call of one generate step, one
    inpaint-UNet step on the Zero123++ canvas and one repaint inpaint step;
    K6 held to groupnorm_limit at every signature of a generate step, an
    inpaint step and the 960x640 decode. A signature or shape no earlier
    path held becomes a shape record, with its launches on this path. Every
    run holds its launches to its census (`counted`). `models`
    (teacher, mlp) go to the driver's ConTEXTure. Returns (the launches by
    kernel, the path's seconds)."""
    import gc
    import shutil
    from collections import Counter

    from contexture_nerf_tpu_torch import check_gt_zero123plus as cg
    from contexture_nerf_tpu_torch import get_depth_maps_cond_grid as gd
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        scale_latents
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops.grid import merge_6_to_grid
    from contexture_nerf_tpu_torch.ops.image import (crop_and_resize,
                                                     get_nonzero_region_tuple,
                                                     resize_nearest)
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {k: 0 for k in _build.launch_counts}
    shapes = Counter()  # the path's launches by call sizes
    work = ROOT / "build" / "generation_path"
    shutil.rmtree(work, ignore_errors=True)
    grids, gt = work / "grids", work / "gt"
    peaks = {}

    def run(label, fn):
        torch.cuda.reset_peak_memory_stats()
        out, secs = counted(torch, fn, label, launches, failures, shapes)
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, secs

    def in_range(x, slack=0.0):
        return bool(torch.isfinite(x).all()) and \
            float(x.min()) >= -slack and float(x.max()) <= 1 + slack

    # (1) the cond-grid driver, then the repaint
    t_boot, t_re = {}, {}
    (ct, rgb1, mask1), boot_s = run(
        "(1) get_depth_maps_cond_grid (7 views, paint step 1)",
        lambda: gd.main(["--shape_path", str(ROOT / "shapes" / "torus.obj"),
                         "--text", "a photo of a dairy cow", "--out_dir",
                         str(grids), f"--optim.seed={seed}"], device="cuda",
                        timings=t_boot, **models))
    pose = ct.dataloaders["train"].poses()[0]
    (rgb2, mask2), re_s = run(
        "(1) ConTEXTure.paint_viewpoint again (paint step 2: median fill, "
        "inpaint UNet)", lambda: ct.paint_viewpoint(pose, timings=t_re))
    mh, mw, Mh, Mw = get_nonzero_region_tuple(mask1[0, 0])
    box = torch.zeros_like(rgb1, dtype=torch.bool)
    box[..., mh:Mh, mw:Mw] = True
    kept = torch.equal(rgb1[~box], rgb2[~box]) and torch.equal(mask1, mask2)
    moved = float((rgb1[box] - rgb2[box]).abs().max())
    # the decode is clipped to [0, 1]; the antialiased resize that pastes
    # it back into the frame may round a weight sum to 1 + 1 ulp
    ranges = [in_range(x, 1e-6) for x in (rgb1, rgb2)]
    ok = all(ranges) and kept and ct.paint_step == 2
    res = ct.cfg.render.train_grid_size
    print(f"  paint steps 1 and 2 at {res}^2 (box {mh}:{Mh}, {mw}:{Mw}): in "
          f"[0, 1] within 1e-6 {ranges[0]} / {ranges[1]} (max "
          f"{float(rgb1.max()):.8f} / {float(rgb2.max()):.8f}); equal "
          f"outside the box {kept}; max |change| inside {moved:.4f} "
          f"{'ok' if ok else 'BAD'}")
    for label, t_ in (("paint step 1", t_boot), ("paint step 2", t_re)):
        print(f"  {label} by phase: " + ", ".join(
            f"{k} {v:.1f}" for k, v in t_.items()) + f" ms [{card}]")
    if not ok:
        failures.append("generation path: the two paint passes")

    # (2) check_gt_zero123plus on the two PNGs
    t_gen = {}
    (pipe, grid), gen_s = run(
        f"(2) check_gt_zero123plus ({GEN_STEPS} steps)",
        lambda: cg.main(["--cond", str(grids / "cond_image.png"),
                         "--depth_grid", str(grids / "depth_grid.png"),
                         "--out_dir", str(gt), "--steps", str(GEN_STEPS)],
                        device="cuda", timings=t_gen))
    t = pipe.tile_px
    H, W = 3 * t, 2 * t
    down = pipe.vae_config.downsample
    lat_hw = (H // down, W // down)
    names = sorted(p.name for p in gt.iterdir())
    written = names == ["grid.png"] + [f"view_{i}.png" for i in range(6)]
    cond = cg.load_image(grids / "cond_image.png", (t, t)).to(dev) * 2 - 1
    depth = cg.load_image(grids / "depth_grid.png", (W, H)).to(dev)

    def gen(**kw):
        return pipe.generate(
            cond, depth, num_inference_steps=GEN_STEPS,
            guidance_scale=cg.GUIDANCE_SCALE, height=H, width=W,
            generator=torch.Generator(device=dev).manual_seed(cg.SEED), **kw)

    again, again_s = run("(2) generate again from the same draws", gen)
    same = torch.equal(grid, again)
    ok = written and in_range(grid) and tuple(grid.shape) == (1, 3, H, W)
    print(f"  {GEN_STEPS}-step generate at {H}x{W}: wrote {names}; grid in "
          f"[0, 1] {in_range(grid)}, mean {float(grid.mean()):.4f}; again "
          f"from the same draws bit-identical {same} (max |diff| "
          f"{float((grid - again).abs().max()):.3e}) "
          f"{'ok' if ok and same else 'BAD'}")
    if not (ok and same):
        failures.append("generation path: check_gt_zero123plus's grid")

    # (3) blending and inpainting
    def mask_grid():
        cache, _ = tr.define_view_weights(ct.mesh_model, ct.cfg.render)
        tiles = [crop_and_resize(cache.mask[i:i + 1], get_nonzero_region_tuple(
            cache.mask[i, 0]), t, t) for i in range(1, cache.mask.shape[0])]
        return merge_6_to_grid(torch.cat(tiles))

    mask_px, _ = run("(3) the 6 views' masks", mask_grid)
    mask = (resize_nearest(mask_px, lat_hw) > 0.5).float()
    mask_up = resize_nearest(mask, (H, W))
    cond_grid = merge_6_to_grid(((cond + 1) / 2).repeat(6, 1, 1, 1))
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    eps = torch.randn((2, pipe.vae_config.latent_channels) + lat_hw,
                      generator=g, device=dev)

    def encode(img, e):
        z = pipe.encode_condition_image(img * 2 - 1, e[None])
        return scale_latents(z.float() * pipe.vae_config.scaling_factor)

    (renders, masked), _ = run(
        "(3) renders and masked latents (two VAE encodes)",
        lambda: (encode(cond_grid, eps[0]),
                 encode(cond_grid * (1 - mask_up) + 0.5 * mask_up, eps[1])))
    pipe.attach_inpaint_unet(ct.diffusion.inpaint_unet)
    t_inp = {}
    blended, inp_s = run(
        "(3) generate, use_blending and use_inpaint",
        lambda: gen(use_blending=True, use_inpaint=True,
                    latent_mask_grid=mask, latent_renders_grid=renders,
                    masked_input_latents=masked, timings=t_inp))
    ones, _ = run("(3) generate, use_blending, mask 1",
                  lambda: gen(use_blending=True,
                              latent_mask_grid=torch.ones_like(mask),
                              latent_renders_grid=renders))
    zeros, _ = run("(3) generate, use_blending, mask 0",
                   lambda: gen(use_blending=True,
                               latent_mask_grid=torch.zeros_like(mask),
                               latent_renders_grid=renders))
    decoded, _ = run(
        "(3) the decode of the renders", lambda: pipe.decode_grid(renders))
    share = float(mask.mean())
    ones_same, zeros_same = torch.equal(ones, grid), torch.equal(zeros,
                                                                  decoded)
    ok = (in_range(blended) and 0 < share < 1 and ones_same and zeros_same)
    print(f"  blending + inpainting: mask share {share:.4f} (1 = generate); "
          f"grid in [0, 1] {in_range(blended)}, differs from the plain one "
          f"by {float((blended - grid).abs().max()):.4f}; mask 1 = the plain "
          f"grid bit for bit {ones_same}; mask 0 = the decode of the renders "
          f"bit for bit {zeros_same} {'ok' if ok else 'BAD'}")
    if not ok:
        failures.append("generation path: blending and inpainting")

    # (4) the kernels against their plain versions on this path's inputs
    ts, sigmas = pipe.euler.timesteps_and_sigmas(GEN_STEPS)
    draws = pipe.draw_generation((t, t), len(ts), H, W, torch.Generator(
        device=dev).manual_seed(seed))
    with torch.no_grad():
        cond_lat_pair, ehs = pipe.prepare_conditioning(
            cond, draws["eps_cond"], draws["eps_neg"])
        cn_emb = pipe.embed_control_cond(depth, lat_hw)
    lat = draws["latents"] * sigmas[0]
    i = 12  # a step inside the inpaint range
    nine = pipe.euler.scale_model_input(torch.cat(
        [torch.cat([lat, mask, masked], dim=1)] * 2), sigmas[i])
    sd = ct.diffusion
    sd_lat = torch.randn(sd.latent_shape(), generator=g, device=dev)
    sd_mask = torch.ones((1, 1) + sd.latent_shape()[2:], device=dev)
    sd_nine = torch.cat([torch.cat([sd_lat, sd_mask, sd_lat], dim=1)] * 2)
    text = ct.text_z[1]

    def main_step():
        return pipe._cfg_v_pred(
            lat, ts[0], cond_lat_pair, ehs, depth, cg.GUIDANCE_SCALE,
            draws["write_neg"][0], draws["write_cond"][0], cn_cond_emb=cn_emb,
            scale_input=lambda x: pipe.euler.scale_model_input(x, sigmas[0]))

    def inpaint_step():
        return pipe.inpaint_unet(nine, ts[i], ehs)

    def repaint_step():
        return sd.inpaint_unet(sd_nine, 501, text)

    steps = (("one generate step (main UNet)", main_step, [pipe]),
             ("one inpaint-UNet step (the 120x80 canvas latent)",
              inpaint_step, [pipe.inpaint_unet]),
             ("one repaint inpaint step (its 64^2 latent)", repaint_step,
              [sd.inpaint_unet]))
    seen_att, seen_gn = set(ATTENTION_SEEN), set(GROUPNORM_SEEN)
    new_att, sigs = {}, {}
    with torch.no_grad():
        for label, fn, towers in steps:
            _build.reset_launch_counts()
            with census(keep_calls=True) as c:
                traffic = groupnorm_traffic(torch, towers, fn)
            hold_to_census(c, f"(4) {label}", failures)
            for args in c.calls:
                key = attention_shape(args)
                if key not in seen_att:
                    new_att.setdefault(key, (label, args))
            err, _, _ = check_routed_calls(torch, c.calls, label, failures)
            for name in ("flash_attn_single", "flash_attn_two_source"):
                recs[name].d["max_abs_err"] = max(recs[name].d["max_abs_err"],
                                                  err)
            for key, (n, a) in traffic["sigs"].items():
                sigs.setdefault(key, [0, a])[0] += n
            del c
        dec = groupnorm_traffic(torch, [pipe.vae_decoder],
                                lambda: pipe.decode_grid(renders))
        for key, (c, a) in dec["sigs"].items():
            sigs.setdefault(key, [0, a])[0] += c
    per_sig = {}
    ms, pms, lms, err, dms, ldms = groupnorm_signature_times(
        torch, sigs, failures, "generation", per_sig=per_sig)
    recs["groupnorm"].d["max_abs_err"] = max(recs["groupnorm"].d[
        "max_abs_err"], err)
    print(f"  K6 at the {len(sigs)} signatures of a generate step, an "
          f"inpaint step, a repaint inpaint step and the {H}x{W} decode "
          f"({dec['calls']} calls, bound {dec['bound_ms']:.3f} ms): ms "
          f"{ms:.3f} plain_ms {pms:.3f} library_ms {lms:.3f}; device time "
          f"K6 {dms:.3f}, library {ldms:.3f}; max_abs_err {err:.3e}")
    gn_src = "contexture_nerf_tpu_torch/csrc/groupnorm.cu"
    new_recs = []  # shape records keyed as _build.launch_shapes keys
    for key, d in per_sig.items():
        if key in seen_gn:
            continue
        skey = ("groupnorm", *key[0])
        if skey not in shape_recs:
            shape_recs[skey] = Record(
                f"groupnorm (generation path, {tuple(key[0])})", gn_src,
                "contexture_nerf_tpu/ops/groupnorm.py:69", H100_FP32_FLOPS)
            new_recs.append(skey)
        shape_recs[skey].add(d["err"], d["ms"], d["pms"], 12.0 * d["numel"],
                             d["bytes"], lib_ms=d["lms"])
    for key, (label, args) in new_att.items():
        kind = "flash_attn_two_source" if key[4] else "flash_attn_single"
        new_recs.append((kind, *key))
        shape_recs[new_recs[-1]] = attention_shape_record(
            torch, args, f"{kind} (generation path: {label}, {key})")
    record_launches({k: shape_recs[k] for k in new_recs}, shapes,
                    "on the generation path", failures)

    secs = time.perf_counter() - t_phase
    print(f"  generate: {GEN_STEPS} steps {gen_s:.2f} s whole ("
          f"conditioning {t_gen.get('generate_conditioning', 0):.1f} ms, a "
          f"step {t_gen.get('generate_steps', 0) / GEN_STEPS:.1f} ms, the "
          f"{H}x{W} decode {t_gen.get('generate_decode', 0):.1f} ms); again "
          f"{again_s:.2f} s; with blending and inpainting {inp_s:.2f} s (a "
          f"step {t_inp.get('generate_steps', 0) / GEN_STEPS:.1f} ms) "
          f"[{card}]")
    print("  peak memory by run: " + "; ".join(
        f"{k} {v:.2f} GiB" for k, v in peaks.items()) + f" [{card}]")
    print(f"  generation path {secs:.1f} s (paint steps {boot_s:.1f} + "
          f"{re_s:.1f} s)")
    pipe.attach_inpaint_unet(None)
    del ct, pipe, sd
    gc.collect()
    torch.cuda.empty_cache()
    return launches, secs


# -- the tools: the semantic smoke, the root drivers, the mesh's face normals,
# volume rendering ------------------------------------------------------------------------

SMOKE_ERR = 0.15  # semantic smoke: err_after at most this (the reference's 0.13)
VOLUME_RAYS, VOLUME_SAMPLES = 65536, 64  # bench.py's bench_volume shape
VOLUME_TOL = 1e-4  # card against CPU, rgb / depth / acc, same draws
FACE_NORMAL_OUTPUTS = ("mask", "depth", "normals", "face normals")


def smoke_ok(res):
    return res["err_after"] <= SMOKE_ERR and \
        res["err_after"] < res["err_before"] / 2


def drawn_object(path):
    """(width, height, share of pixels off the white or grey background)
    of a written PNG."""
    import numpy as np
    from PIL import Image

    a = np.asarray(Image.open(path).convert("RGB"), np.int16)
    bg = (np.abs(a - 255).max(-1) <= 2) | (np.abs(a - 127).max(-1) <= 2)
    return a.shape[1], a.shape[0], float(1 - bg.mean())


def tools_path(torch, seed, models, failures):
    """The tools at full width on the card. (1) The semantic smoke at its
    defaults (200 production SDS steps of a tiny ConTEXTure against the
    trained-by-construction teacher): err_after within SMOKE_ERR and below
    half of err_before; then a planted fault, a teacher that asks for
    green, must miss that. (2) One run_one of each root driver on the torus
    with `models` (the main path's teacher and MLP, and an SD2-depth stack
    made here) at 2 SDS iterations and a 2-frame eval: the two rendering
    drivers' 7 crops 320x320 with the object in them, the ablation's
    metrics; every run's launches held to its census. (3)
    render_face_normals_face_idx on the torus's 7 views at 1200^2 (K5 once)
    against the plain rasterizer on the card, bit for bit, and at 128^2
    against the CPU run. (4) volume_render at bench.py's shape (65,536
    rays, 64 coarse + 64 fine samples) against the CPU on the same draws,
    to VOLUME_TOL, and its rays/s. (5) `user_tools`: knob_quality and
    compare_outputs. Returns (launches by kernel, seconds)."""
    import shutil

    from contexture_nerf_tpu_torch import generate_survey_textures as gs
    from contexture_nerf_tpu_torch import get_texture_renders_cond_grid as gr
    from contexture_nerf_tpu_torch import run_ablation_study as ab
    from contexture_nerf_tpu_torch.core.config import (GuideConfig,
                                                       RenderConfig)
    from contexture_nerf_tpu_torch.diffusion.sd_depth import \
        StableDiffusionDepth
    from contexture_nerf_tpu_torch.models import volume as V
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel
    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.tools import semantic_smoke as sm
    from contexture_nerf_tpu_torch.training import trainer as tr

    card = card_line()
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {k: 0 for k in _build.launch_counts}
    work = ROOT / "build" / "tools_path"
    shutil.rmtree(work, ignore_errors=True)

    def run(label, fn):
        out, secs = counted(torch, fn, label, launches, failures)
        print(f"    {secs:.1f} s")
        return out, secs

    # (1) the semantic smoke, then the green-target fault
    res, smoke_s = run("(1) semantic smoke (200 steps)",
                       lambda: sm.run(work / "smoke", device="cuda"))
    print(f"  smoke result.json: {json.dumps(res)}; err_after within "
          f"{SMOKE_ERR} and below half err_before: "
          f"{'ok' if smoke_ok(res) else 'BAD'} [{card}]")
    if not smoke_ok(res):
        failures.append(f"semantic smoke: {res}")
    bad, _ = run("(1) planted fault: a teacher that asks for green",
                 lambda: sm.run(work / "smoke_green", device="cuda",
                                teacher_rgb=(0.2, 1.0, 0.2)))
    print(f"  fault's err_before {bad['err_before']} err_after "
          f"{bad['err_after']}: {'NOT CAUGHT' if smoke_ok(bad) else 'caught'}")
    if smoke_ok(bad):
        failures.append("semantic smoke: the green-target fault passed")

    # (2) the root drivers on the torus, with the main path's towers
    torus = str(ROOT / "shapes" / "torus.obj")
    sd = StableDiffusionDepth(device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    models = dict(models, diffusion=sd)
    cut = {"optim": {"seed": seed, "sds_iterations": 2},
           "log": {"exp_root": str(work / "runs"), "full_eval_size": 2,
                   "log_images": False, "save_mesh": False}}

    def crops_ok(label, written):
        shapes = [drawn_object(p) for p in written]
        ok = len(written) == 7 and all(
            (w, h) == (320, 320) and share > 0.05 for w, h, share in shapes)
        print(f"  {label}: {len(written)} crops, sizes "
              f"{sorted({(w, h) for w, h, _ in shapes})}, object share "
              f"{min(s for _, _, s in shapes):.3f}-"
              f"{max(s for _, _, s in shapes):.3f} {'ok' if ok else 'BAD'}")
        if not ok:
            failures.append(f"{label}: crops {shapes}")

    (_, written), _ = run(
        "(2) generate_survey_textures.run_one",
        lambda: gs.run_one(torus, "a photo of a dairy cow",
                           work / "survey", overrides=cut, device="cuda",
                           **models))
    crops_ok("survey crops", written)
    pair = dict(gr.PAIRS[1], path=torus)
    (_, written), _ = run(
        "(2) get_texture_renders_cond_grid.run_one",
        lambda: gr.run_one(pair, pair["prompts"][1], work / "renders",
                           overrides=cut, device="cuda", **models))
    crops_ok("texture-render crops", written)
    ablation, _ = run(
        "(2) run_ablation_study.run_one (gi 3, gt 5)",
        lambda: ab.run_one(3, 5, overrides=dict(
            cut, guide={"shape_path": torus}), device="cuda", **models))
    metrics = json.loads((ablation.exp_path / "metrics.json").read_text())
    ok = bool(metrics) and all(math.isfinite(e["sds_loss"]) for e in metrics
                               if "sds_loss" in e)
    print(f"  ablation run: individual control "
          f"{ablation.cfg.guide.individual_control_of_conditions}, "
          f"{len(metrics)} metric entries, finite {ok}")
    if not ok:
        failures.append("ablation run: metrics")
    del sd, models, ablation
    torch.cuda.empty_cache()

    # (3) the face normals of the torus's 7 views
    th, ph, rad = (torch.tensor(v) for v in tr.view_angles(RenderConfig()))
    meshes = {}

    def face_normals(res_px, device):
        if (res_px, device) not in meshes:
            meshes[(res_px, device)] = TexturedMeshModel(
                GuideConfig(shape_path=torus), render_grid_size=res_px,
                texture_resolution=16, device=device)
        return meshes[(res_px, device)].render_face_normals_face_idx(
            th, ph, rad)

    card_out, _ = run("(3) render_face_normals_face_idx 7x1200^2",
                      lambda: face_normals(1200, "cuda"))
    with plain_paths(torch, k5=True, k1=False):
        plain_out = face_normals(1200, "cuda")
    same = all(torch.equal(a, b) for a, b in zip(card_out, plain_out))
    small = face_normals(128, "cuda")
    cpu = face_normals(128, "cpu")
    idx_same = torch.equal(small[4].cpu(), cpu[4])
    # the CPU tests' limits against the reference: the camera math's
    # rounding, scaled by 1/den on faces seen edge-on, moves the normalized
    # depth by up to 1e-3 and the unit normals by ~1e-5
    errs = {name: (float((a.cpu() - b).abs().max()), lim) for name, a, b, lim
            in zip(FACE_NORMAL_OUTPUTS, small[:4], cpu[:4],
                   (0.0, 1e-3, 1e-4, 1e-4))}
    ok = same and idx_same and all(e <= lim for e, lim in errs.values())
    print(f"  face normals at 1200^2: K5 against the plain rasterizer on the "
          f"card bit for bit {same}; at 128^2 against the CPU: face indices "
          f"equal {idx_same}, max |diff| (limit) " + ", ".join(
              f"{k} {e:.2e} ({lim})" for k, (e, lim) in errs.items())
          + f" {'ok' if ok else 'BAD'}")
    if not ok:
        failures.append("render_face_normals_face_idx card != plain / CPU")
    del card_out, plain_out, meshes

    # (4) volume rendering at bench.py's shape
    R, S = VOLUME_RAYS, VOLUME_SAMPLES

    def ball(pts):
        d = torch.linalg.norm(pts, dim=-1)
        return pts, torch.where(d < 0.5, 50.0, 0.0)

    g = torch.Generator().manual_seed(seed)
    u_c, u_f = torch.rand((R, S), generator=g), torch.rand((R, S), generator=g)

    def rays(device):
        o = torch.tensor([0.0, 0.0, 1.5], device=device).expand(R, 3)
        return o, torch.tensor([0.0, 0.0, -1.0], device=device).expand(R, 3)

    def render(device):
        return V.volume_render(ball, *rays(device), n_coarse=S, n_fine=S,
                               u_coarse=u_c.to(device),
                               u_fine=u_f.to(device))

    on_card, cpu = render(dev), render("cpu")
    err = {k: float((on_card[k].cpu() - cpu[k]).abs().max())
           for k in ("rgb", "depth", "acc")}
    ms = cuda_ms(lambda: render(dev))
    ok = all(e <= VOLUME_TOL for e in err.values())
    print(f"  volume_render {R} rays x ({S} + {S}) samples: max |card - CPU| "
          + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
          + f" (limit {VOLUME_TOL}) {'ok' if ok else 'BAD'}; {ms:.3f} ms, "
          f"{R / ms * 1e3:.4g} rays/s [{card}]")
    if not ok:
        failures.append(f"volume_render card != CPU: {err}")

    # (5) knob_quality's two paints, then compare_outputs on their outputs
    user_tools(torch, seed, work, card, failures)
    secs = time.perf_counter() - t_phase
    print(f"  tools path {secs:.1f} s")
    return launches, secs


KNOB_RUN_DIFF = {"optim.local_sds_grad", "optim.precompute_uv_embedding"}


def knob_runs_check(default, knobs, cmp):
    """What is wrong with knob_quality's defaults run `default` against its
    knobs run `knobs` (run directories; `cmp` its `compare` of the two):
    their configs must differ in the two knobs alone, and their atlases
    must differ (a finite PSNR). [] when nothing is."""
    from contexture_nerf_tpu_torch.tools import knob_quality

    bad = []
    diff = knob_quality.config_diff(default, knobs)
    if set(diff) != KNOB_RUN_DIFF:
        bad.append(f"config.yaml differs in {diff}, not in "
                   f"{sorted(KNOB_RUN_DIFF)} alone")
    if not math.isfinite(cmp.get("texture_atlas_psnr_db", math.inf)):
        bad.append(f"atlas PSNR {cmp.get('texture_atlas_psnr_db')} dB: the "
                   f"two runs painted the same atlas")
    return bad


def user_tools(torch, seed, work, card, failures):
    """knob_quality's defaults and knobs paints (2 iterations each, its
    production scale, each a CLI process of its own whose launches this
    process does not count) and its comparison, held by knob_runs_check:
    the two runs' configs differ in the two knobs alone and their atlases
    differ; the same check on the defaults run given as both runs (the
    reference tool's comparison of a run with itself) must fail. Then
    compare_outputs on the two runs' results/ (the pairing, PSNR and JSON
    line; with random towers the PSNR says only that the tools run) and on
    one run against itself (inf, exit 0)."""
    import contextlib
    import io

    from contexture_nerf_tpu_torch.tools import compare_outputs, knob_quality

    root = work / "knob_quality"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "contexture_nerf_tpu_torch.tools.knob_quality",
         "--iters", "2", "--seed", str(seed), "--skip",
         "knobq_emb_only,knobq_seed1", "--exp-root", str(root)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    kq_s = time.perf_counter() - t0
    if r.returncode != 0:
        failures.append(f"knob_quality exited {r.returncode}: "
                        f"{r.stdout[-1500:]}{r.stderr[-1500:]}")
        return
    res = json.loads(r.stdout.strip().splitlines()[-1])
    cmp = res.get("default_vs_knobs", {})
    frames = cmp.get("eval_render_psnr_db", {}).get("per_frame", [])
    default, knobs = root / "knobq_default", root / "knobq_knobs"
    bad = knob_runs_check(default, knobs, cmp)
    resolved = res.get("resolved_knobs", {})
    want = {"knobq_default": dict.fromkeys(knob_quality.KNOBS, False),
            "knobq_knobs": dict.fromkeys(knob_quality.KNOBS, True)}
    if resolved != want:
        bad.append(f"resolved knobs {resolved}, not {want}")
    if len(frames) != 8:
        bad.append(f"{len(frames)} eval frames compared, not 8")
    print(f"  (5) knob_quality --iters 2 (defaults and knobs): {kq_s:.1f} s "
          f"(paints {json.dumps(res['wall_clock'])}); resolved knobs "
          f"{json.dumps(resolved)}; config.yaml differs in "
          f"{json.dumps(knob_quality.config_diff(default, knobs))}; default "
          f"vs knobs: atlas {cmp.get('texture_atlas_psnr_db')} dB, albedo "
          f"{cmp.get('albedo_psnr_db')} dB, eval frames "
          f"{cmp.get('eval_render_psnr_db', {}).get('mean')} dB mean over "
          f"{len(frames)}; sds_loss {json.dumps(cmp.get('sds_loss'))} "
          f"{'ok' if not bad else 'BAD'} [{card}]")
    failures.extend(f"knob_quality: {b}" for b in bad)
    planted = knob_runs_check(default, default,
                              knob_quality.compare(default, default))
    print(f"  (5) planted fault: the defaults run as both runs (a run against "
          f"itself): {'caught: ' + '; '.join(planted) if planted else 'MISSED'}")
    if not planted:
        failures.append("knob_runs_check passed the defaults run against "
                        "itself")
    out = {}
    for label, argv in (("two runs", [str(default / "results"),
                                      str(knobs / "results")]),
                        ("a run against itself", [str(default / "results"),
                                                  str(default / "results")])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = compare_outputs.main(argv)
        out[label] = (rc, json.loads(buf.getvalue().splitlines()[-1]))
    (rc2, two), (rc1, self_) = out["two runs"], out["a run against itself"]
    ok = (two["pairs"] >= 1 and not two["missing"] and rc2 == int(
        not two["pass"]) and rc1 == 0 and self_["pass"]
        and self_["value"] == float("inf"))
    print(f"  (5) compare_outputs default/results knobs/results: exit {rc2},"
          f" {json.dumps(two)}; against itself: exit {rc1}, worst "
          f"{self_['value']} dB {'ok' if ok else 'BAD'}")
    if not ok:
        failures.append(f"compare_outputs: {out}")


PARALLEL_MAX_RANKS = 4
PARALLEL_DEADLINE_S = 420.0  # a rank alive past it fails the path
LOSS_RTOL, PARAM_ATOL = 1e-3, 5e-5  # the reference's dryrun tolerances
# The MLP's gradients before Adam, relative Frobenius distance from the
# single-device step's. Adam's first step moves a parameter by about lr
# (1e-5) whatever the gradient's scale, so PARAM_ATOL alone cannot see a
# gradient n times too large, a missing sum or a wrong backward collective.
GRAD_RTOL = 1e-3
TP_REL_FRO_F32 = 1e-4  # a TP teacher call in f32: sums reordered
# bf16 TP / SP: the call's (or the step's gradients') distance from the f32
# single-device run, at most this x the replicated bf16 run's distance
TP_BF16_MARGIN = 1.5
LOSS_RTOL_BF16 = 1e-2  # TP / SP steps: the bf16 teacher's sums reordered
RING_SHAPE = (2, 5, 9600, 64)  # the teacher's largest self-attention
# planted faults of the sharded step, each of which the step checks must
# catch (chip_smoke.py parallel path, tests/test_torch_parallel.py)
PARALLEL_FAULTS = {
    "n_fold_gather": "the gathered canvas's gradient summed n times (the "
                     "autograd all-gather's backward)",
    "no_grad_reduce": "the MLP's gradients left unsummed over views",
    "tp_copy_no_reduce": "a tp layer's input gradient not summed over tp",
    "tp_row_no_reduce": "a row-parallel Dense's partial sums not reduced",
}


def mlp_grads(mlp):
    """The MLP's gradients as the last step left them: summed over `views`,
    what Adam's update took."""
    return {k: p.grad.detach().clone() for k, p in mlp.named_parameters()}


def grads_rel(a, b):
    """||a - b|| / ||b|| over every tensor of the dicts a and b."""
    import torch

    return rel_fro(torch.cat([a[k].float().reshape(-1) for k in b]),
                   torch.cat([b[k].float().reshape(-1) for k in b]))


def step_errors(got, ref):
    """(loss relative error, max |param diff|, gradients' relative
    Frobenius distance) of a step's (params, loss, grads) from ref's."""
    (p2, l2, g2), (p1, l1, g1) = got, ref
    perr = max(float((p2[k].float() - p1[k].float()).abs().max())
               for k in p1)
    return abs(l2 - l1) / max(1.0, abs(l1)), perr, grads_rel(g2, g1)


def step_ok(errs, loss_rtol=LOSS_RTOL):
    loss, param, grad = errs
    return loss <= loss_rtol and param <= PARAM_ATOL and grad <= GRAD_RTOL


@contextlib.contextmanager
def planted_parallel_fault(name):
    """One of PARALLEL_FAULTS planted in parallel/{mesh, tp}.py while the
    block runs."""
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.parallel import tp

    if name == "n_fold_gather":
        def bad(ctx, g):
            n, r, dim = ctx.conf
            return n * pm.block(g, n, r, dim).contiguous(), None, None
        owner, attr, bad = pm._GatherRows, "backward", staticmethod(bad)
    elif name == "no_grad_reduce":  # the trainer's sum (tp imports its own)
        owner, attr = pm, "all_reduce_sum"

        def bad(x, group):
            return x
    elif name == "tp_copy_no_reduce":
        def bad(ctx, g):
            return g, None
        owner, attr, bad = tp._CopyToTP, "backward", staticmethod(bad)
    elif name == "tp_row_no_reduce":
        def bad(ctx, x, group):
            return x.clone()
        owner, attr, bad = tp._ReduceFromTP, "forward", staticmethod(bad)
    else:
        raise ValueError(name)
    old = owner.__dict__[attr]
    setattr(owner, attr, bad)
    try:
        yield
    finally:
        setattr(owner, attr, old)


@contextlib.contextmanager
def plain_attention():
    """Attention off K3/K4 (which take bf16) for the f32 runs; the ring
    route under sequence_parallel stays."""
    from contexture_nerf_tpu_torch.ops import attention as A

    kernel_rule = A.routes_to_kernel
    A.routes_to_kernel = lambda *a: False
    try:
        yield
    finally:
        A.routes_to_kernel = kernel_rule


def f32_teacher(torch, teacher):
    """A copy of `teacher` that computes in f32: its parameters, and every
    module's compute and output dtype."""
    import copy

    t = copy.deepcopy(teacher).float()
    for m in t.modules():
        for attr in ("dtype", "out_dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, torch.float32)
    return t


def parallel_rank(dev, seed, work):
    """One rank of the parallel path (run by `run_ranks` on NCCL;
    see parallel_path). Returns {"lines", "failures", "launches"}."""
    import copy

    import torch

    from contexture_nerf_tpu_torch.ops import _build
    from contexture_nerf_tpu_torch.ops.attention import flash_attention_plain
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.parallel import tp
    from contexture_nerf_tpu_torch.parallel.ring import ring_attention
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, rank = pm.world_size(), pm.rank()
    card = card_line() if rank == 0 else ""
    lines, failures = [], []
    launches = {k: 0 for k in _build.launch_counts}

    def counted_run(label, fn):
        """fn() under the census with the counts set to 0 just before; the
        launches held to the census (K3, K4, K6, gn_bwd)."""
        _build.reset_launch_counts()
        with census() as c:
            out = fn()
            torch.cuda.synchronize(dev)
        got = hold_to_census(c, f"parallel path {label}", failures,
                             lines.append)
        for k in launches:
            launches[k] += got[k]
        return out

    cfg = main_config(seed)
    cfg.optim.data_parallel = "on"
    cfg.log.exp_root = str(work)
    cfg.log.full_eval_size = 8
    cfg.log.save_mesh = False
    cfg.log.log_images = False
    run = tr.ConTEXTure(cfg, device=dev)
    setup = tr.prepare_sds(cfg, run.mesh_model, run.mlp, run.teacher,
                           skip_bootstrap=True, generator=run.generator)
    mlp0 = copy.deepcopy(run.mlp)

    def trainer(mesh, teacher=None):
        return tr.SDSTrainer(cfg, setup, teacher=teacher or run.teacher,
                             mlp=copy.deepcopy(mlp0), device=dev,
                             generator=run.generator,
                             mesh_model=run.mesh_model, mesh=mesh)

    # (1) the SDS step: single device, then each mode, from one state and
    # draws; each step's MLP gradients (summed over `views`) kept
    single = trainer(None)
    draws = single.draw()
    meshes = {"single": None,
              "dp": tr.make_mesh(cfg) or pm.create_mesh((n,), ("views",))}
    if n > 1:
        for k, name in (("tensor_parallel", "tp2"),
                        ("sequence_parallel", "sp2")):
            setattr(cfg.optim, k, 2)
            meshes[name] = tr.make_mesh(cfg)
            setattr(cfg.optim, k, 1)
    tp_teacher = copy.deepcopy(run.teacher) if n > 1 else None

    def sharded(name, teacher=None):
        return single if name == "single" else trainer(
            meshes[name], teacher or (tp_teacher if name == "tp2" else None))

    results = {}
    for name in meshes:
        t = sharded(name)
        pm.collective_counts.clear()
        params, loss, *_ = counted_run(
            f"(1) {name} step, mesh "
            f"{None if t.mesh is None else tuple(t.mesh.mesh.shape)} "
            f"{None if t.mesh is None else t.mesh.mesh_dim_names}",
            lambda: t.step(500, draws))
        results[name] = (params, float(loss), mlp_grads(t.mlp))
        coll = dict(pm.collective_counts)
        torch.cuda.reset_peak_memory_stats(dev)
        t.step(500)  # warm
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(2):
            t.step(500)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / 2 * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        lines.append(f"  (1) {name}: loss {float(loss):.6f}, {ms:.2f} ms a "
                     f"step, peak {peak:.2f} GiB, collectives a step "
                     f"{json.dumps(coll)} [{card}]")
        del t
    ref = results["single"]

    def report(label, errs, ok, limits):
        lines.append(f"  (1) {label}: loss {errs[0]:.3e} rel, max |param "
                     f"diff| {errs[1]:.3e}, gradients {errs[2]:.3e} rel "
                     f"Frobenius ({limits}) {'ok' if ok else 'BAD'}")
        if not ok:
            failures.append(f"parallel path: {label}")

    if n == 1:
        p2, l2, g2 = results["dp"]
        same = l2 == ref[1] and all(torch.equal(p2[k], ref[0][k])
                                    and torch.equal(g2[k], ref[2][k])
                                    for k in ref[0])
        report("dp against the single-device step",
               step_errors(results["dp"], ref), same,
               f"bit-identical {same}, required at world size 1")
        lines.append("  (1f) the planted faults need two ranks or more; at "
                     "world size 1 they are held on gloo CPU ranks by "
                     "tests/test_torch_parallel.py")
    else:
        limits = f"limits {LOSS_RTOL}, {PARAM_ATOL}, {GRAD_RTOL}"
        errs = step_errors(results["dp"], ref)
        report("dp against the single-device step", errs, step_ok(errs),
               limits)
        # TP / SP in f32 (attention off K3/K4, which take bf16) against the
        # f32 single-device step at the same limits; then the bf16 steps'
        # gradients no farther from the f32 single step's than
        # TP_BF16_MARGIN x the bf16 single step's, and their loss within
        # LOSS_RTOL_BF16 of the bf16 single step's
        draws32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in draws.items()}
        t32 = f32_teacher(torch, run.teacher)
        tp32 = f32_teacher(torch, run.teacher)
        r32 = {}
        with plain_attention():
            for name in ("single", "tp2", "sp2"):
                t = trainer(meshes[name], tp32 if name == "tp2" else t32)
                params, loss, *_ = t.step(500, draws32)
                r32[name] = (params, float(loss), mlp_grads(t.mlp))
                del t
        del t32, tp32
        base = grads_rel(ref[2], r32["single"][2])
        far_limit = max(TP_BF16_MARGIN * base, GRAD_RTOL)
        for name in ("tp2", "sp2"):
            errs = step_errors(r32[name], r32["single"])
            report(f"{name} in f32 against the f32 single-device step", errs,
                   step_ok(errs), limits)
            errs = step_errors(results[name], ref)
            far = grads_rel(results[name][2], r32["single"][2])
            ok = errs[0] <= LOSS_RTOL_BF16 and far <= far_limit
            report(f"{name} in bf16 against the bf16 single-device step",
                   errs, ok, f"loss limit {LOSS_RTOL_BF16}; gradients from "
                   f"the f32 single step's {far:.3e}, the bf16 single "
                   f"step's {base:.3e}, limit {far_limit:.3e}")
        # (1f) the planted faults, each of which the checks above must catch
        for fault, name in (("n_fold_gather", "dp"), ("no_grad_reduce", "dp"),
                            ("tp_copy_no_reduce", "tp2"),
                            ("tp_row_no_reduce", "tp2")):
            t = sharded(name)
            with planted_parallel_fault(fault):
                params, loss, *_ = t.step(500, draws)
            got = (params, float(loss), mlp_grads(t.mlp))
            del t
            errs = step_errors(got, ref)
            if name == "dp":
                caught = not step_ok(errs)
                alone = (errs[0] <= LOSS_RTOL and errs[1] <= PARAM_ATOL)
                how = (f"caught {caught}; loss and params alone pass it "
                       f"{alone}")
            else:
                far = grads_rel(got[2], r32["single"][2])
                caught = not (errs[0] <= LOSS_RTOL_BF16 and far <= far_limit)
                how = (f"gradients from the f32 single step's {far:.3e}; "
                       f"caught {caught}; the loss limit {LOSS_RTOL_BF16} "
                       f"alone catches it {errs[0] > LOSS_RTOL_BF16}")
            lines.append(f"  (1f) planted fault {fault} "
                         f"({PARALLEL_FAULTS[fault]}) in the {name} step: "
                         f"loss {errs[0]:.3e} rel, max |param diff| "
                         f"{errs[1]:.3e}, gradients {errs[2]:.3e} rel; {how}"
                         f" {'ok' if caught else 'BAD'}")
            if not caught:
                failures.append(f"parallel path: fault {fault} not caught")
    del tp_teacher

    # (2) ring attention at the teacher's largest self-attention
    B, H, S, d = RING_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, ek, ev = (torch.randn((B, H, S, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(5))
    sp_mesh = pm.create_mesh((n,), ("sp",))
    for label, extra in (("one source", ()), ("two sources", (ek, ev))):
        out = counted_run(f"(2) ring_attention {label} {RING_SHAPE}",
                          lambda: ring_attention(q, k, v, sp_mesh, "sp",
                                                 *extra))
        ref = flash_attention_plain(*(t.float() for t in (q, k, v) + extra))
        err = (out.float() - ref).abs()
        ok = bool((err <= bf16_ulp(torch, ref) + 1e-6).all())
        ms = cuda_ms(lambda: ring_attention(q, k, v, sp_mesh, "sp", *extra),
                     reps=3, warmup=1)
        lines.append(f"  (2) ring_attention, {label}, over {n} rank(s): max "
                     f"|out - plain f32| {float(err.max()):.3e}, within one "
                     f"bf16 ulp (+ 1e-6) of the plain output {ok}; "
                     f"{ms:.2f} ms "
                     f"[{card}]")
        if not ok:
            failures.append(f"parallel path: ring_attention {label}")
    del q, k, v, ek, ev, out, ref

    # (3) a TP teacher call against the replicated call
    tp_mesh = pm.create_mesh((n,), ("tp",))
    z = torch.randn(single.latent_shape(), generator=g, device=dev
                    ).to(single.dtype)
    t_t = torch.tensor([500], device=dev)

    def call(teacher):
        return teacher._cfg_v_pred(z, t_t, single.cond_lat_pair, single.ehs,
                                   single.depth_grid, tr.GUIDANCE_SCALE,
                                   draws["neg_noise"], draws["cond_noise"],
                                   cn_cond_emb=single.cn_cond_emb)

    towers = ("unet", "controlnet", "vae_encoder")

    def shard(teacher):
        for name in towers:
            tp.shard_params_tp(getattr(teacher, name), tp_mesh)
        return teacher

    sharded = shard(copy.deepcopy(run.teacher))
    with torch.no_grad():
        rep = counted_run("(3) replicated teacher call",
                          lambda: call(run.teacher))
        got = counted_run(f"(3) teacher call, towers sharded over tp={n}",
                          lambda: call(sharded))
    held = sum(tp.parameter_bytes(getattr(sharded, t)) for t in towers)
    del sharded
    # the same two calls in f32 (attention through the plain path, which
    # takes f32): the function itself, and how far bf16 moves the call
    t32 = f32_teacher(torch, run.teacher)
    sharded32 = shard(f32_teacher(torch, run.teacher))
    with plain_attention(), torch.no_grad():
        rep32, got32 = (teacher._cfg_v_pred(
            z.float(), t_t, single.cond_lat_pair.float(),
            single.ehs.float(), single.depth_grid, tr.GUIDANCE_SCALE,
            draws["neg_noise"].float(), draws["cond_noise"].float(),
            cn_cond_emb=single.cn_cond_emb.float())
            for teacher in (t32, sharded32))
    del t32, sharded32
    rel, rel32 = rel_fro(got, rep), rel_fro(got32, rep32)
    err_rep, err_tp = rel_fro(rep, rep32), rel_fro(got, rep32)
    same = torch.equal(got, rep)
    ok = same if n == 1 else (
        rel32 <= TP_REL_FRO_F32
        and err_tp <= max(TP_BF16_MARGIN * err_rep, TP_REL_FRO_F32))
    sizes = {k: sum(tp.sharded_bytes(getattr(run.teacher, t), k)
                    for t in towers) / 2 ** 30 for k in (1, 2, 4)}
    lines.append(f"  (3) TP teacher call over {n} rank(s) against the "
                 f"replicated call: rel Frobenius {rel32:.3e} in f32, "
                 f"{rel:.3e} in bf16; from the f32 call: the sharded bf16 "
                 f"call {err_tp:.3e}, the replicated {err_rep:.3e}; "
                 f"bit-identical {same} ("
                 + ("required at world size 1" if n == 1 else
                    f"limits: f32 {TP_REL_FRO_F32}; bf16 within "
                    f"{TP_BF16_MARGIN}x the replicated call's distance") +
                 f") "
                 f"{'ok' if ok else 'BAD'}; per-rank parameter GiB of the "
                 f"UNet, ControlNet and VAE encoder at tp = 1, 2, 4: "
                 + ", ".join(f"{v:.3f}" for v in sizes.values())
                 + f" (held here {held / 2 ** 30:.3f}) [{card}]")
    if not ok:
        failures.append("parallel path: the TP teacher call")
    del rep, got, rep32, got32

    # (4) the sharded 8-frame eval against the single frames
    views = pm.create_mesh((n,), ("views",))
    out_dir = Path(work) / "eval"
    counted_run(f"(4) eval, 8 frames in chunks of {n}",
                lambda: run.evaluate(run.dataloaders["val_large"],
                                     out_dir / "sharded", mesh=views))
    if rank == 0:
        import numpy as np
        from PIL import Image

        run.evaluate(run.dataloaders["val_large"], out_dir / "single",
                     mesh=None)
        a = sorted((out_dir / "sharded").glob("*.jpg"))
        b = sorted((out_dir / "single").glob("*.jpg"))
        same = len(a) == len(b) == 8 and all(
            x.name == y.name and np.array_equal(np.asarray(Image.open(x)),
                                                np.asarray(Image.open(y)))
            for x, y in zip(a, b))
        lines.append(f"  (4) sharded eval: {len(a)} frames, equal to the "
                     f"single frames {same} [{card}]")
        if not same:
            failures.append("parallel path: the sharded eval")
    return {"lines": lines, "failures": failures, "launches": launches}


def parallel_path(torch, seed, failures):
    """Several GPUs (parallel/{mesh, ring, tp}, the trainer's mesh): one
    NCCL rank per visible GPU, up to PARALLEL_MAX_RANKS, started by
    parallel/launch.py `run_ranks` with a deadline (a rank that fails or hangs fails
    the path; nothing retries on gloo or the CPU). Each rank builds the
    main path's models at full width (prepare_sds without the bootstrap)
    and runs: (1) the SDS step on this rank alone, then with
    data_parallel=on over every rank (a 1-rank views mesh at world size 1;
    TP = 2 and SP = 2 too from 2 ranks), from the same state and draws:
    bit-identical at world size 1 (the MLP's gradients too), else DP within
    the reference's dryrun tolerances and the gradients within GRAD_RTOL;
    TP / SP in f32 against the f32 single step at those limits, and in
    bf16 with the loss within LOSS_RTOL_BF16 and the gradients no farther
    from the f32 single step's than TP_BF16_MARGIN x the bf16 single
    step's (their bf16 teacher sums in other orders); the PARALLEL_FAULTS
    planted one at a time, each of which must fail its step's check; each
    mode's ms a step, peak GiB and collectives a step;
    (2) ring_attention at the teacher's (2, 5, 9600, 64) self-attention,
    with and without the second source, within one bf16 ulp (+ 1e-6) of
    plain f32 attention; (3) a teacher call with its towers sharded over
    every rank against the replicated call: bit-identical at world size
    1, else in f32 within TP_REL_FRO_F32 and in bf16 no farther from the
    f32 call than TP_BF16_MARGIN x the replicated bf16 call; the per-rank
    parameter bytes at tp = 1, 2, 4; (4) the 8-frame eval in
    chunks over `views` against the single frames, bit for bit. Every
    run's launches are held to its census. Returns (rank 0's launches,
    seconds)."""
    from contexture_nerf_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    n = max(1, min(PARALLEL_MAX_RANKS, torch.cuda.device_count()))
    work = ROOT / "build" / "parallel_path"
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    print(f"  world size {n} ({torch.cuda.device_count()} visible GPU(s), "
          f"NCCL, deadline {PARALLEL_DEADLINE_S:.0f} s)")
    if n == 1:
        print("  world size 1: no multi-rank collective was exercised on "
              "the card; the collectives ran over a group of one rank, and "
              "the multi-rank paths are held on gloo CPU ranks by "
              "tests/test_torch_parallel.py")
    try:
        res = run_ranks(n, parallel_rank, "cuda",
                        kwargs={"seed": seed, "work": str(work)},
                        timeout_s=PARALLEL_DEADLINE_S, threads=4)
    except Exception as e:  # a rank raised, or the deadline passed
        failures.append(f"parallel path: {str(e)[-3000:]}")
        return {}, time.perf_counter() - t0
    for line in res[0]["lines"]:
        print(line)
    for r, got in enumerate(res):
        failures.extend(f"rank {r}: {f}" for f in got["failures"])
    secs = time.perf_counter() - t0
    print(f"  parallel path {secs:.1f} s [{card_line()}]")
    return res[0]["launches"], secs


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
    ap.add_argument("--snapshot-only", action="store_true",
                    help="run only the snapshot phase (a random-tower CLI "
                    "run, then the same run from its towers written to "
                    "disk) and stop (no kernel phases, no result line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only K1/K2 at the fit's and the lattice's "
                    "point counts and the mesh path (a mesh without UVs, its "
                    "atlas, the kaolin-compatible entries, the fit, the "
                    "exact and the masked steps, the mesh as an OFF through "
                    "the CLI) and stop (no result line)")
    ap.add_argument("--generate-only", action="store_true",
                    help="run only the generation path (the two "
                    "ground-truth drivers, generate's blending and "
                    "inpainting, its kernels against the plain versions) on "
                    "towers of its own and stop (no result line)")
    ap.add_argument("--int8-only", action="store_true",
                    help="run only the int8 path (the W8A8 teacher's "
                    "layers against the CPU, planted faults, SDS steps in "
                    "bf16 / int8_controlnet / int8_teacher) on a trainer of "
                    "its own, without the bootstrap, and stop (no result "
                    "line)")
    ap.add_argument("--tools-only", action="store_true",
                    help="run only the tools path (the semantic smoke, the "
                    "root drivers, the face normals, volume rendering) on "
                    "towers of its own and stop (no result line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run only the parallel path (one NCCL rank per "
                    "visible GPU, up to 4: the sharded SDS step, ring "
                    "attention, a TP teacher call, the sharded eval) and "
                    "stop (no result line)")
    ap.add_argument("--flux-only", action="store_true",
                    help="run only FLUX.1 Depth's phases (K3 at head dim "
                    "128 at its shapes, a full-width step's launches, "
                    "spans and time) and stop")
    ap.add_argument("--sv3d-only", action="store_true",
                    help="run only SV3D_p's kernel shapes (K3, K6 forward "
                    "and gn_bwd) and its paint loop at full width (the "
                    "launches, spans and host reads of a step, its time) "
                    "and stop (no result line)")
    ap.add_argument("--k7-only", action="store_true",
                    help="run only the K7 phase (the masked texture sample "
                    "and its backward at the exact path's shapes and a "
                    "ragged one) and print its records")
    ap.add_argument("--k5-times-of", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_script = time.perf_counter()
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
        "groupnorm_bwd": Record(
            f"groupnorm_bwd (gn_bwd; the step's {STEP_SLICE[0]}x"
            f"{STEP_SLICE[1]} slice encode, 22 calls)", GN_BWD_SRC,
            GN_BWD_REPLACES, peak=H100_FP32_FLOPS),
    }
    from contexture_nerf_tpu_torch.core.config import config_from_dict

    # the mesh path's shapes, keyed as _build.launch_shapes keys launches;
    # their launches are the mesh path's
    mlp_src = "contexture_nerf_tpu_torch/csrc/mlp_fwd.cu"
    bwd_src = "contexture_nerf_tpu_torch/csrc/mlp_bwd.cu"
    raster_src = "contexture_nerf_tpu_torch/csrc/raster.cu"
    k1_at, k2_at = ("contexture_nerf_tpu/ops/mlp_kernel.py:81",
                    "contexture_nerf_tpu/ops/mlp_kernel.py:93")
    k5_at = "contexture_nerf_tpu/raster/pallas_raster.py:41"
    lattice = 1024 * 1024
    cfg0 = config_from_dict({})
    res, tres = cfg0.render.train_grid_size, cfg0.guide.texture_resolution
    faces = numpy_uv_sphere(MESH_LAT, MESH_LON)[1].shape[0]
    shape_recs = {
        ("mlp_fwd", 4096): Record(
            "mlp_fwd (fit_texture_to_image, N=4096)", mlp_src, k1_at),
        ("mlp_bwd", 4096): Record(
            "mlp_bwd (fit_texture_to_image, N=4096)", bwd_src, k2_at),
        ("mlp_fwd", lattice): Record(
            f"mlp_fwd (the uv lattice, N={lattice})", mlp_src, k1_at),
        ("mlp_bwd", lattice): Record(
            f"mlp_bwd (exact_lattice_render's lattice, N={lattice})", bwd_src,
            k2_at),
        ("raster", 1, res, res, faces): Record(
            f"raster (unwrapped {faces}-face mesh, the bootstrap's front pose "
            f"1x{res}^2)", raster_src, k5_at, H100_FP32_FLOPS),
        ("raster", 7, res, res, faces): Record(
            f"raster (unwrapped {faces}-face mesh, prepare_sds's 7 views "
            f"7x{res}^2)", raster_src, k5_at, H100_FP32_FLOPS),
        ("raster", 1, tres, tres, faces): Record(
            f"raster (its UV-space atlas, 1x{tres}^2)", raster_src, k5_at,
            H100_FP32_FLOPS),
        K7_FWD_KEY: Record(
            f"texture_fwd (K7; the exact path's {K7_VIEWS}x{res}^2 views, "
            f"{tres}^2 texture)", K7_SRC, K7_REPLACES, H100_FP32_FLOPS),
        K7_BWD_KEY: Record(
            f"texture_bwd (K7; the exact path's {K7_VIEWS}x{res}^2 views, "
            f"{tres}^2 texture)", K7_SRC, K7_REPLACES, H100_FP32_FLOPS),
        ("groupnorm_bwd", "canvas"): Record(
            f"groupnorm_bwd (gn_bwd; the exact path's {STEP_CANVAS[0]}x"
            f"{STEP_CANVAS[1]} canvas encode, 22 calls)", GN_BWD_SRC,
            GN_BWD_REPLACES, H100_FP32_FLOPS, keys=sorted({
                ("groupnorm_bwd", *shape) for shape, _ in
                vae_encoder_groupnorms(*STEP_CANVAS)})),
    }
    # K1/K2's shapes: the SDS step's (embedding in), a ragged count, the
    # fit's and the texture lattice's (uv in)
    step_mlp = [("canvas", 960 * 640, "emb", recs["mlp_fwd"], None),
                ("slice", 448 * 448, "emb", recs["mlp_fwd"], recs["mlp_bwd"]),
                ("ragged", 1000, "emb", HELD, HELD)]
    mesh_mlp = [("fit", 4096, "uv", shape_recs[("mlp_fwd", 4096)],
                 shape_recs[("mlp_bwd", 4096)]),
                ("lattice", lattice, "lattice",
                 shape_recs[("mlp_fwd", lattice)],
                 shape_recs[("mlp_bwd", lattice)])]

    if args.mesh_only:
        from contexture_nerf_tpu_torch.diffusion.zero123plus import \
            Zero123PlusTeacher

        print("K1/K2 at the fit's and the lattice's point counts (kernel "
              "vs plain, bf16):")
        mlp_phases(torch, args.seed, mesh_mlp, failures)
        print("mesh path: a 100,000-face mesh without UVs on a teacher of "
              "its own")
        dev = torch.device("cuda")
        teacher = Zero123PlusTeacher(device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed))
        mesh_path(torch, args.seed, teacher, shape_recs, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    if args.int8_only:
        from contexture_nerf_tpu_torch.training import trainer as tr

        print("int8 path alone, on a trainer of its own (prepare_sds "
              "without the bootstrap)")
        trainer, _ = tr.build_sds_trainer(main_config(args.seed),
                                          device="cuda", skip_bootstrap=True)
        int8_path(torch, args.seed, trainer, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    if args.k7_only:
        print("K7 phase (the masked texture sample and its backward against "
              "their plain versions, f32):")
        texture_phase(torch, args.seed, shape_recs, failures)
        for f in failures:
            print(f"FAIL: {f}")
        if failures:
            return 1
        print(json.dumps({"kernels": [shape_recs[k].out() for k in (
            K7_FWD_KEY, K7_BWD_KEY)]}))
        return 0
    if args.flux_only:
        flux_recs = flux_phases(torch, args.seed, failures)
        for f in failures:
            print(f"FAIL: {f}")
        if failures:
            return 1
        print(json.dumps({"kernels": [r.out() for r in flux_recs.values()]}))
        return 0
    if args.sv3d_only:
        sv3d_recs = sv3d_phases(torch, args.seed, failures)
        for f in failures:
            print(f"FAIL: {f}")
        if failures:
            return 1
        print(json.dumps({"kernels": [r.out() for r in sv3d_recs.values()]}))
        return 0
    if args.parallel_only:
        print("parallel path alone")
        parallel_path(torch, args.seed, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    if args.tools_only:
        from contexture_nerf_tpu_torch.diffusion.zero123plus import \
            Zero123PlusTeacher
        from contexture_nerf_tpu_torch.models.fields import NeRF2D

        print("tools path alone, on towers of its own")
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        tools_path(torch, args.seed, {
            "teacher": Zero123PlusTeacher(device=dev, generator=gen),
            "mlp": NeRF2D(generator=gen, device=dev)}, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    if args.generate_only:
        print("generation path alone, on towers of its own")
        generation_path(torch, args.seed, {}, recs, {}, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
    if args.snapshot_only:
        print("snapshot path: the CLI on spot_quick_test.yaml with random "
              "towers, then from the same towers written to disk")
        snapshot_path(torch, args.seed, None, failures)
        for f in failures:
            print(f"FAIL: {f}")
        return 1 if failures else 0
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
    mlp_phases(torch, args.seed, step_mlp + mesh_mlp, failures)
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
    print("K6 backward phase (gn_bwd vs its closed form at the VAE "
          "encoder's 22 GroupNorms, bf16):")
    groupnorm_bwd_phase(torch, args.seed, [
        ("slice", STEP_SLICE, recs["groupnorm_bwd"]),
        ("canvas", STEP_CANVAS, shape_recs[("groupnorm_bwd", "canvas")])],
        failures)
    print("K7 phase (the masked texture sample and its backward against "
          "their plain versions, f32):")
    texture_phase(torch, args.seed, shape_recs, failures)
    sv3d_recs = sv3d_phases(torch, args.seed, failures)
    flux_recs = flux_phases(torch, args.seed, failures)
    print("main path: shapes/torus.obj -> prepare_sds (SD2-depth bootstrap) "
          "-> full-width SDS steps")
    launches, trainer = main_path(torch, args.seed, args.profile, recs,
                                  failures)
    print("int8 path: the W8A8 teacher (optim.int8_controlnet / "
          "optim.int8_teacher) on main_path's trainer")
    quantized, int8_s = int8_path(torch, args.seed, trainer, failures)
    launches = {k: launches[k] + quantized[k] for k in launches}
    print("paint path: the CLI on configs/text_guided/spot_quick_test.yaml "
          "(10 iterations, full-width towers), its resume, then full_eval, "
          "the view-consistency metric and the UV-space atlas at the "
          "default config's sizes on the torus")
    painted, reference = paint_path(torch, args.seed, trainer, recs,
                                    failures)
    launches = {k: launches[k] + painted[k] for k in launches}
    print("mesh path: a 100,000-face mesh without UVs (its atlas unwrapped "
          "and cached), rasterize and render_multiple_view_texture, the fit, "
          "exact_lattice_render, reference_texture, the mesh as an OFF "
          "through the CLI, on main_path's teacher")
    meshed = mesh_path(torch, args.seed, trainer.teacher, shape_recs,
                       failures)
    launches = {k: launches[k] + meshed[k] for k in launches}
    print("generation path: get_depth_maps_cond_grid on the torus and a "
          "repaint, check_gt_zero123plus (28 steps at 960x640), generate's "
          "blending and inpainting, on main_path's teacher and MLP")
    generated, gen_s = generation_path(
        torch, args.seed, {"teacher": trainer.teacher, "mlp": trainer.mlp},
        recs, shape_recs, failures)
    launches = {k: launches[k] + generated[k] for k in launches}
    print("tools path: the semantic smoke, the root drivers on main_path's "
          "towers, the face normals, volume rendering")
    tooled, tools_s = tools_path(
        torch, args.seed, {"teacher": trainer.teacher, "mlp": trainer.mlp},
        failures)
    launches = {k: launches[k] + tooled[k] for k in launches}
    del trainer
    print("snapshot path: the paint path's first CLI run from its towers "
          "written to disk as diffusers snapshots")
    from_disk = snapshot_path(torch, args.seed, reference, failures)
    launches = {k: launches[k] + from_disk[k] for k in launches}
    print("parallel path: one NCCL rank per visible GPU (up to 4), each at "
          "full width: the sharded SDS step against the single-device step, "
          "ring attention, a TP teacher call, the sharded 8-frame eval")
    par, par_s = parallel_path(torch, args.seed, failures)
    launches = {k: launches[k] + par.get(k, 0) for k in launches}
    for name, rec in recs.items():
        rec.d["launches"] = launches.get(name, 0)
        if rec.d["launches"] == 0:
            failures.append(f"{name} was not launched on the main path")
    total = time.perf_counter() - t_script
    print(f"profiler windows: {PROFILER_WINDOWS['taken']} taken; without "
          f"device time, by try: "
          f"{json.dumps(PROFILER_WINDOWS['empty by try'])}, holding "
          f"{PROFILER_WINDOWS['events in empty']} events; each taken again "
          f"with twice the reps and the padding")
    print(f"generation path {gen_s:.1f} s, int8 path {int8_s:.1f} s, tools "
          f"path {tools_s:.1f} s, parallel path {par_s:.1f} s of the "
          f"script's {total:.1f} s "
          f"[{card_line()}]")
    if failures:
        for f in failures:
            print(f"FAIL: {f}")
        return 1
    print(json.dumps({"kernels": [r.out() for r in (
        *recs.values(), *shape_recs.values(), *sv3d_recs.values(),
        *flux_recs.values())]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
