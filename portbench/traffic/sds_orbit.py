"""Traffic `sds_orbit`: one texture's closed SDS loop under a video teacher
(SV3D_p) over its orbit of frames.

Set-up makes every input from the seed on the device: the towers' weights
(each blender's mix_factor 0.5 + 0.25 N(0, 1), near SVD's initial 0.5),
the MLP's, the orbit's frames of the torus from the benchmark's own plain
geometry (reference/sv3d.py `orbit_frames`), the condition latent and the
CLIP context drawn N(0, 1); builds the program's `OrbitSDSTrainer` on them
and drives it through its first `check_steps` steps at iterations `start`,
`start` + 1, ... of the DreamTime schedule of `iterations` steps over the
1000 indices of the EDM table; those steps are the warm-up, and their
draws, Fisher divergences, first gradient and parameter change are what
the reference is held to. The window runs `SDSTrainer.step` back to back
as `sds_loop` does (sds_loop.window); the traced window runs `trace_steps`
steps after as many untraced ones and keeps the program's own spans only.

Parameters (the cell's `params`): iterations, start, check_steps,
log_every, trace_steps, and the orbit as the program must run it: frames,
frame_px, elevation_deg, guidance, cond_aug (checked against the
program's teacher at full size).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

from portbench import common, tracekit
from portbench import weights as W
from portbench.reference import sds as ref_sds
from portbench.reference import sv3d as ref
from portbench.reference import towers as rt
from portbench.traffic import sds_loop
# the timed window, the counts and the peak are sds_loop's
from portbench.traffic.sds_loop import counts, peak_bytes, window  # noqa: F401
from portbench.work import sv3d as work

TOWERS = ("unet", "vae_encoder", "vision_encoder")
ORBIT = ("frames", "frame_px", "elevation_deg", "guidance", "cond_aug")
MIX = "mix_factor"


def make_tower(leaves, seed, name, device, dtype):
    """portbench/weights.py's tower, each blender's mix_factor moved to
    0.5 + 0.25 times its N(0, 1) draw."""
    made = W.make_tower(leaves, seed, name, device, dtype)
    return {k: (0.5 + 0.25 * v if k.endswith(MIX) else v)
            for k, v in made.items()}


def plant(torch, trainer, fault):
    """A fault under the timed path, for the benchmark's own tests and the
    limits' readings: 'unchanged' (the step leaves the MLP as it was),
    'half_batch' (the loss over half of the sampled frame's rows, scaled to
    their mean), 'altered' (Adam's update of the output layer's weight
    doubled), 'spatial_only' (every blender's weight on its spatial half
    forced to 1: the temporal layers drop out). Returns an undo function."""
    if fault in (None, "unchanged", "altered"):
        return sds_loop.plant(torch, trainer, None, fault)
    if fault == "half_batch":
        orig = trainer._sampled

        def half(x, frame):
            y = orig(x, frame)
            h = y.shape[1] // 2
            return torch.cat([y[:, :h] * 2 ** 0.5,
                              torch.zeros_like(y[:, h:])], dim=1)

        trainer._sampled = half
        return lambda: None
    if fault == "spatial_only":
        with torch.no_grad():
            for m in trainer.teacher.unet.mixers():
                m.mix_factor.fill_(1e4)
        return lambda: None
    raise ValueError(f"no fault {fault!r}")


def setup(cell, seed, torch, device="cuda", tiny=False, fault=None,
          control=False):
    from contexture_nerf_tpu_torch.diffusion.sv3d import SV3DTeacher
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.training.orbit import OrbitSDSTrainer

    p = cell.params
    dev = torch.device(device)
    clock = common.Phases(torch, dev)
    torch.zeros(1, device=dev)
    clock("device start")
    cfg = common.train_config(cell, tiny, control)
    teacher = SV3DTeacher(tiny=tiny, device="meta")
    if not tiny:
        common.check_unet(cell, teacher.unet_config)
        got = {"frames": teacher.frames, "frame_px": teacher.frame_px,
               "elevation_deg": teacher.elevation_deg,
               "guidance": teacher.guidance, "cond_aug": teacher.cond_aug}
        if {k: p[k] for k in ORBIT} != got:
            raise ValueError(f"the program's orbit is {got}, the cell "
                             f"states {({k: p[k] for k in ORBIT})}")
    clock("teacher modules")
    T, P = teacher.frames, teacher.frame_px
    render_px = 96 if tiny else cfg.render.train_grid_size
    g = ref.orbit_frames(cfg.guide.shape_path, render_px, P, T,
                         teacher.elevation_deg, cfg.guide.shape_scale,
                         cfg.guide.dy, cfg.render.radius, dev)
    clock("geometry")
    if dev.type == "cuda":
        # the peak from here on is the program's: the plain rasterizer's
        # buffers are the benchmark's own
        torch.cuda.reset_peak_memory_stats()
    specs = {t: W.spec(getattr(teacher, t)) for t in TOWERS}
    for t in TOWERS:
        W.install(getattr(teacher, t),
                  make_tower(specs[t], seed, t, dev, teacher.dtype))
    teacher.make_tables(dev)
    mlp = NeRF2D(device="meta")
    W.install(mlp, W.make_mlp(W.spec(mlp), seed, dev), requires_grad=True)
    params0 = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    clock("weights")

    gen = torch.Generator(device=dev).manual_seed(W.tower_seed(seed, "inputs"))
    lat = P // teacher.vae_config.downsample
    ctx = teacher.unet_config.cross_attention_dim
    inputs = {
        "mask_frames": g["mask_frames"], "uv_frame_pts": g["uv_pts"],
        "edit_mask_pts": None,
        "z_cond": torch.randn((1, teacher.vae_config.latent_channels, lat,
                               lat), generator=gen, device=dev
                              ).to(teacher.dtype),
        "context": torch.randn((1, 1, ctx), generator=gen, device=dev
                               ).to(teacher.dtype),
        "frame_probs": torch.full((T,), 1.0 / T, device=dev)}
    draw_gen = torch.Generator(device=dev).manual_seed(
        W.tower_seed(seed, "draws"))
    trainer = OrbitSDSTrainer(cfg, inputs, teacher=teacher, mlp=mlp,
                              tiny=tiny, device=dev, generator=draw_gen,
                              mesh=None)
    undo = plant(torch, trainer, fault)
    clock("trainer")
    ts = ref.schedule(p["iterations"])
    it = p["start"]
    beta1 = cfg.optim.sds_betas[0]
    draws, losses, fishers, grads1, v_preds = [], [], [], None, []
    teach = trainer._teacher

    def recorded(*a):
        v = teach(*a)
        v_preds.append(v.detach().float().clone())
        return v

    # the check steps record the teacher's answer; the window runs the
    # class's own method (the attribute goes after them)
    trainer._teacher = recorded
    for i in range(p["check_steps"]):
        d = trainer.draw()
        draws.append({k: v.detach().clone() for k, v in d.items()})
        _, loss, _, fisher, _ = trainer.step(ts[it], draws=d)
        losses.append(loss.detach().clone())
        fishers.append(fisher.detach().clone())
        if i == 0:
            st = trainer.optimizer.state
            grads1 = {n: (st[q]["exp_avg"].detach().clone() / (1 - beta1)
                          if q in st else torch.zeros_like(q))
                      for n, q in mlp.named_parameters()}
        it += 1
    del trainer._teacher
    params_n = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    clock("first steps")
    vcfg = ref_vae_config(teacher.vae_config)
    work_counts = work.sds_step(ref_unet_config(teacher.unet_config), vcfg,
                                T, P, itemsize=teacher.dtype.itemsize)
    return SimpleNamespace(
        cell=cell, cfg=cfg, seed=seed, dev=dev, tiny=tiny, trainer=trainer,
        teacher=teacher, specs=specs, inputs=inputs, params0=params0,
        draws=draws, losses=losses, fishers=fishers, v_preds=v_preds,
        diagnostics={},
        phases=clock.times, grads1=grads1, params_n=params_n, ts=ts, it=it,
        undo=undo, window_losses=[], window_peak=0, work=work_counts,
        frames=T, frame_px=P, orbit=(T, teacher.elevation_deg,
                                     teacher.cond_aug, teacher.guidance),
        setup_peak=(torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else 0))


def ref_unet_config(c) -> ref.VideoUNetConfig:
    return ref.VideoUNetConfig(c.in_channels, c.out_channels,
                               c.block_out_channels, c.layers_per_block,
                               c.cross_attention_dim, c.num_heads,
                               c.transformer_depth, c.adm_in_channels,
                               c.frames)


def ref_vae_config(c) -> rt.VAEConfig:
    return rt.VAEConfig(c.in_channels, c.latent_channels,
                        c.block_out_channels, c.layers_per_block,
                        c.scaling_factor)


def traced_window(state, torch) -> tracekit.Trace:
    """`trace_steps` steps untraced, then as many under the profiler, each
    in a `pb.unit` span; the readers take the program's spans."""
    k = state.cell.params["trace_steps"]
    common.sync(torch, state.dev)
    t0 = time.perf_counter()
    for _ in range(k):
        state.window_losses.append(sds_loop._step(state))
    common.sync(torch, state.dev)
    untraced_ms = (time.perf_counter() - t0) * 1e3 / k
    events = tracekit.profile_units(
        torch, SimpleNamespace(calls={}), k,
        lambda: state.window_losses.append(sds_loop._step(state)))
    state.window_peak = torch.cuda.max_memory_allocated()
    w = state.work
    return tracekit.Trace(events, k, {},
                          {"unit_flops": w["flops"],
                           "k3_flops": w["k3_flops"],
                           "k6_bytes": w["k6_bytes"]}, untraced_ms)


def rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b||."""
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bf16_sensitivity(torch, unet, args, out, guidance) -> float:
    """The seed's own sensitivity to bf16 rounding: the relative L2 gap of
    the guided v-prediction of the f32 reference UNet's call on `args`
    (its output `out`) when every Linear and convolution output is rounded
    to bf16. The seeded towers' rounding gaps vary by seed (1.7x over 24
    seeds), in the sound run and the control alike."""
    mods = [m for m in unet.modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d,
                              torch.nn.Conv3d))]
    hooks = [m.register_forward_hook(
        lambda m, i, o: o.to(torch.bfloat16).to(o.dtype)) for m in mods]
    try:
        with torch.no_grad():
            rounded = unet(*args)
    finally:
        for h in hooks:
            h.remove()

    def guided(o):
        v_u, v_c = o.chunk(2)
        return v_u + guidance * (v_c - v_u)

    return rel_l2(torch, guided(rounded), guided(out))


def leaf_vector_gaps(torch, prog: dict, refr: dict) -> dict:
    """Each leaf's ||prog - ref|| over the larger of the reference leaf's
    norm and the median leaf's (common.leaf_gaps compares the norms
    alone): a fault that keeps a gradient's norm and turns it
    (half_batch) shows here."""
    norms = {n: float(torch.linalg.vector_norm(v.float()))
             for n, v in refr.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n: float(torch.linalg.vector_norm(prog[n].float() - v.float()))
            / max(norms[n], med) for n, v in refr.items()}


def check(state, torch) -> dict:
    """Free the program, run the reference through the same steps from the
    same weights, inputs and draws, and compare: `vpred_gap`, the worst
    step's relative L2 gap of the guided v-prediction over all the frames
    (the teacher's answer itself) in units of the seed's bf16 sensitivity
    (`bf16_sensitivity`); each step's Fisher divergence over all the
    frames (the v-prediction against the v-target); the first gradient
    and the parameters' change after the steps, leaf by leaf, as
    `sds_loop` does, and the first gradient's own gap, leaf by leaf
    (`grad_vec_gap`, leaf_vector_gaps)."""
    cell, dev, tiny = state.cell, state.dev, state.tiny
    opt = state.cfg.optim
    state.undo()
    change_p = {n: state.params_n[n] - state.params0[n] for n in state.params0}
    ucfg = ref_unet_config(state.teacher.unet_config)
    vcfg = ref_vae_config(state.teacher.vae_config)
    state.trainer = state.teacher = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = torch.float32 if tiny else getattr(torch, cell.config["dtype"])
    with ref_sds.exact_f32():
        with torch.device("meta"):
            mods = {"unet": ref.VideoUNet(ucfg), "vae_encoder": rt.Encoder(vcfg)}
        for name, mod in mods.items():
            if W.spec(mod) != state.specs[name]:
                raise ValueError(f"the reference's {name} has other leaves "
                                 "than the program's")
            W.install(mod, make_tower(state.specs[name], state.seed, name,
                                      dev, served), dtype=torch.float32)
        mlp = ref_sds.NeRF2D().to(dev)
        W.install(mlp, {k: v.clone() for k, v in state.params0.items()},
                  requires_grad=True)
        inputs = {"uv_pts": state.inputs["uv_frame_pts"].float(),
                  "mask_frames": state.inputs["mask_frames"].float(),
                  "z_cond": state.inputs["z_cond"].float(),
                  "context": state.inputs["context"].float()}
        r = ref.OrbitSDSReference(
            (mods["unet"], mods["vae_encoder"]), mlp, inputs, state.frame_px,
            vcfg, state.orbit, (opt.sds_lr, opt.sds_betas, opt.sds_eps))
        it = cell.params["start"]
        losses, fishers, grads1, vpred_gaps = [], [], None, []
        calls = []
        hook = mods["unet"].register_forward_hook(
            lambda m, i, o: calls.append((i, o)) if not calls else None)
        for i, d in enumerate(state.draws):
            out = r.step(state.ts[it + i], d)
            losses.append(out["loss"])
            fishers.append(out["fisher"])
            v = out["v_pred"]
            vpred_gaps.append(rel_l2(torch, state.v_preds[i], v))
            if i == 0:
                grads1 = out["grads"]
        hook.remove()
        sensitivity = bf16_sensitivity(torch, mods["unet"], *calls[0],
                                       state.orbit[3])
        change_r = {n: q.detach() - state.params0[n]
                    for n, q in mlp.named_parameters()}

    def rel(p_, r_):
        return [abs(float(a) - b) / max(abs(b), 1e-30) for a, b in zip(p_, r_)]

    grad = common.leaf_gaps(state.grads1, grads1)
    grad_vec = leaf_vector_gaps(torch, state.grads1, grads1)
    change = common.leaf_gaps(change_p, change_r,
                              keep=common.moved_leaves(grads1))
    state.diagnostics = {
        "loss_gaps": rel(state.losses, losses),
        "fisher_gaps": rel(state.fishers, fishers),
        "vpred_gaps": vpred_gaps, "bf16_sensitivity": sensitivity,
        "grad_worst": max(grad, key=grad.get),
        "grad_median": sorted(grad.values())[len(grad) // 2],
        "grad_vec_worst": max(grad_vec, key=grad_vec.get),
        "change_worst": max(change, key=change.get),
        "change_median": sorted(change.values())[len(change) // 2]}
    values = {"vpred_gap": max(vpred_gaps) / sensitivity,
              "fisher_gap": max(state.diagnostics["fisher_gaps"]),
              "grad_gap": max(grad.values()),
              "grad_vec_gap": max(grad_vec.values()),
              "change_gap": max(change.values())}
    nan = float("nan")
    return {k: {"value": v, "limit": cell.limits.get(k, nan)}
            for k, v in values.items()}
