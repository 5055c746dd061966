"""Traffic `sds_flow`: one texture's closed SDS loop under a rectified-flow
teacher (FLUX.1 Depth [dev]) over the 3x2 grid.

Set-up makes every input from the seed on the device: the towers' weights
(the MMDiT's 11.9 B in bf16), the MLP's, the torus's six views from the
benchmark's own plain geometry (their depth, mask and UV grids), the
prompt's T5 states and pooled vector drawn N(0, 1); builds the program's
`FluxSDSTrainer` on them (which encodes the depth grid's control latents)
and drives it through its first `check_steps` steps at iterations `start`,
`start` + 1, ... of the DreamTime schedule of `iterations` steps over the
1000 entries of the shifted flow table; those steps are the warm-up, and
their draws, v-predictions, Fisher divergences, first gradient and
parameter change are what the reference is held to. The window runs
`SDSTrainer.step` back to back as `sds_loop` does (sds_loop.window); the
traced window runs `trace_steps` steps after as many untraced ones and
keeps the program's own spans only.

Parameters (the cell's `params`): iterations, start, check_steps,
log_every, trace_steps, and the grid and call as the program must run
them: tile_px, image_tokens, text_tokens, guidance, mu (checked against
the program's teacher at full size).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

from portbench import common, tracekit
from portbench import weights as W
from portbench.reference import flux as ref
from portbench.reference import sds as ref_sds
from portbench.traffic import sds_loop
# the timed window, the counts and the peak are sds_loop's
from portbench.traffic.sds_loop import counts, peak_bytes, window  # noqa: F401
from portbench.traffic.sds_orbit import leaf_vector_gaps, rel_l2
from portbench.work import flux as work

TOWERS = ("transformer", "vae_encoder")
CALL = ("tile_px", "image_tokens", "text_tokens", "guidance", "mu")


def plant(torch, trainer, fault):
    """A fault under the timed path, for the benchmark's own tests and the
    limits' readings: 'unchanged', 'half_batch', 'altered' as `sds_loop`
    plants them, and 'no_rope' (the rotary embedding skipped in every
    block: q and k enter the attention as they leave the RMSNorm). Returns
    an undo function."""
    from contexture_nerf_tpu_torch.diffusion import flux
    from contexture_nerf_tpu_torch.training import trainer as tr

    if fault == "no_rope":
        orig = flux.apply_rope
        flux.apply_rope = lambda x, cos, sin: x
        return lambda: setattr(flux, "apply_rope", orig)
    return sds_loop.plant(torch, trainer, tr, fault)


def check_config(cell, teacher) -> None:
    """The program runs the tower, the AE and the call the configuration
    and the cell state."""
    got = {k: getattr(teacher.config, k) for k in cell.config["transformer"]}
    want = common.tuples(cell.config["transformer"])
    if got != want:
        raise ValueError(f"the program's transformer is {got}, the "
                         f"configuration states {want}")
    vae = {k: getattr(teacher.vae_config, k) for k in cell.config["vae"]}
    if vae != common.tuples(cell.config["vae"]):
        raise ValueError(f"the program's AE is {vae}, the configuration "
                         f"states {cell.config['vae']}")
    p = cell.params
    call = {"tile_px": teacher.tile_px, "image_tokens": teacher.image_tokens,
            "text_tokens": teacher.text_tokens,
            "guidance": teacher.guidance, "mu": round(teacher.mu, 4)}
    if call != {k: p[k] for k in CALL}:
        raise ValueError(f"the program's call is {call}, the cell states "
                         f"{({k: p[k] for k in CALL})}")


def setup(cell, seed, torch, device="cuda", tiny=False, fault=None,
          control=False):
    from contexture_nerf_tpu_torch.diffusion.flux import FluxDepthTeacher
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.training.trainer import FluxSDSTrainer

    p = cell.params
    dev = torch.device(device)
    clock = common.Phases(torch, dev)
    torch.zeros(1, device=dev)
    clock("device start")
    cfg = common.train_config(cell, tiny, control)
    teacher = FluxDepthTeacher(tiny=tiny, device="meta")
    if not tiny:
        check_config(cell, teacher)
    clock("teacher modules")
    tile = teacher.tile_px
    render_px = 96 if tiny else cfg.render.train_grid_size
    g = common.geometry(cfg, tile, render_px, dev, False)
    clock("geometry")
    if dev.type == "cuda":
        # the peak from here on is the program's: the plain rasterizer's
        # buffers are the benchmark's own
        torch.cuda.reset_peak_memory_stats()
    specs = common.install_towers(teacher, TOWERS, seed, dev, teacher.dtype)
    teacher.make_tables(dev)
    mlp = NeRF2D(device="meta")
    W.install(mlp, W.make_mlp(W.spec(mlp), seed, dev), requires_grad=True)
    params0 = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    clock("weights")

    gen = torch.Generator(device=dev).manual_seed(W.tower_seed(seed, "inputs"))
    txt, vec = teacher.prompt_states(gen)
    inputs = {"depth_grid": g["depth_grid"], "mask_grid": g["mask_grid"],
              "uv_grid_pts": g["uv_pts"], "edit_mask_pts": None,
              "txt": txt, "vec": vec,
              "tile_probs": torch.full((6,), 1.0 / 6.0, device=dev)}
    draw_gen = torch.Generator(device=dev).manual_seed(
        W.tower_seed(seed, "draws"))
    trainer = FluxSDSTrainer(cfg, inputs, teacher=teacher, mlp=mlp,
                             tiny=tiny, device=dev, generator=draw_gen,
                             mesh=None)
    undo = plant(torch, trainer, fault)
    clock("trainer")
    ts = ref.schedule(teacher.image_tokens, p["iterations"])
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
    rcfg = ref.Config.tiny() if tiny else ref.Config()
    work_counts = work.sds_step(rcfg, ref.vae_config(tiny), tile,
                                teacher.text_tokens,
                                cfg.optim.local_sds_margin_px)
    return SimpleNamespace(
        cell=cell, cfg=cfg, seed=seed, dev=dev, tiny=tiny, trainer=trainer,
        teacher=teacher, specs=specs, inputs=inputs, geometry=g,
        params0=params0, draws=draws, losses=losses, fishers=fishers,
        v_preds=v_preds, diagnostics={}, phases=clock.times, grads1=grads1,
        params_n=params_n, ts=ts, it=it, undo=undo, window_losses=[],
        window_peak=0, work=work_counts, tile=tile,
        guidance=teacher.guidance,
        setup_peak=(torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else 0))


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
                           "k3_flops": w["k3_flops"]}, untraced_ms)


def bf16_sensitivity(torch, r, x, t: int, out) -> float:
    """The seed's own sensitivity to bf16 rounding: the relative L2 gap of
    the f32 reference's v-prediction `out` at (x, t) when every Linear and
    convolution output of the MMDiT is rounded to bf16."""
    mods = [m for m in r.flux.modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    hooks = [m.register_forward_hook(
        lambda m, i, o: o.to(torch.bfloat16).to(o.dtype)) for m in mods]
    try:
        with torch.no_grad():
            rounded = r.v_pred(x, t)
    finally:
        for h in hooks:
            h.remove()
    return rel_l2(torch, rounded, out)


def check(state, torch) -> dict:
    """Free the program, run the reference through the same steps from the
    same weights, inputs and draws, and compare as `sds_orbit` does:
    `vpred_gap`, the worst step's relative L2 gap of the v-prediction over
    the whole latent canvas in units of the seed's bf16 sensitivity
    (`bf16_sensitivity`); `fisher_gap`, each step's Fisher divergence over
    the canvas; `grad_gap` and `change_gap`, the first gradient's and the
    parameters' change's norms leaf by leaf, as `sds_loop` does; and
    `grad_vec_gap`, the first gradient itself leaf by leaf."""
    cell, dev, tiny = state.cell, state.dev, state.tiny
    opt = state.cfg.optim
    state.undo()
    change_p = {n: state.params_n[n] - state.params0[n] for n in state.params0}
    state.trainer = state.teacher = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = torch.float32 if tiny else getattr(torch, cell.config["dtype"])
    with ref_sds.exact_f32():
        with torch.device("meta"):
            mods = {"transformer": ref.Flux(ref.Config.tiny() if tiny
                                            else ref.Config()),
                    "vae_encoder": ref.ae_encoder(ref.vae_config(tiny))}
        for name, mod in mods.items():
            if W.spec(mod) != state.specs[name]:
                raise ValueError(f"the reference's {name} has other leaves "
                                 "than the program's")
        # the MMDiT keeps the served dtype (each product upcasts its
        # weight); the AE is small enough to hold in f32
        W.install(mods["transformer"], W.make_tower(
            state.specs["transformer"], state.seed, "transformer", dev,
            served))
        W.install(mods["vae_encoder"], W.make_tower(
            state.specs["vae_encoder"], state.seed, "vae_encoder", dev,
            served), dtype=torch.float32)
        mlp = ref_sds.NeRF2D().to(dev)
        W.install(mlp, {k: v.clone() for k, v in state.params0.items()},
                  requires_grad=True)
        g = state.geometry
        inputs = {"depth_grid": g["depth_grid"].float(),
                  "mask_grid": g["mask_grid"].float(),
                  "uv_pts": g["uv_pts"].float(),
                  "txt": state.inputs["txt"].float(),
                  "vec": state.inputs["vec"].float()}
        r = ref.FluxSDSReference(
            (mods["transformer"], mods["vae_encoder"]), mlp, inputs,
            state.tile, int(opt.local_sds_margin_px),
            (opt.sds_lr, opt.sds_betas, opt.sds_eps), state.guidance)
        it = cell.params["start"]
        losses, fishers, grads1, vpred_gaps, first = [], [], None, [], None
        for i, d in enumerate(state.draws):
            t = state.ts[it + i]
            out = r.step(t, d)
            losses.append(out["loss"])
            fishers.append(out["fisher"])
            vpred_gaps.append(rel_l2(torch, state.v_preds[i], out["v_pred"]))
            if i == 0:
                grads1 = out["grads"]
                first = (out["noisy"], t, out["v_pred"])
        sensitivity = bf16_sensitivity(torch, r, *first)
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
