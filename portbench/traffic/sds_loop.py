"""Traffic `sds_loop`: one texture's closed loop of SDS steps.

Set-up makes every input from the seed on the device (the towers' and the
MLP's weights, the torus's six views from the benchmark's own plain
geometry, the condition latents and hidden states), builds the program's
`SDSTrainer` on them, and drives it through its first `check_steps` steps
at iterations `start`, `start` + 1, ... of the DreamTime schedule of
`iterations` steps; those steps are the warm-up, and their draws, losses,
first gradient and parameter change are what the reference is held to.
The window then runs `SDSTrainer.step` back to back from there, reading the
loss on the host every `log_every` iterations, as the paint loop does, and
ends with a device sync. The traced window runs `trace_steps` steps after
as many untraced ones.

Parameters (the cell's `params`): iterations, start, check_steps,
log_every, trace_steps.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

from portbench import common, tracekit
from portbench import weights as W
from portbench.reference import sds as ref
from portbench.reference import towers as rt
from portbench.work import counts as work

TOWERS = ("unet", "controlnet", "vae_encoder", "text_encoder",
          "vision_encoder")


def plant(torch, trainer, tr, fault):
    """A fault under the timed path, for the benchmark's own tests:
    'unchanged' (the step leaves the MLP as it was), 'half_batch' (the
    loss over half the tile's rows, scaled to their mean), 'altered' (the
    step's answer altered where it is made: Adam's update of the output
    layer's weight doubled).
    Returns an undo function."""
    if fault is None:
        return lambda: None
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
        return lambda: None
    if fault == "half_batch":
        orig = tr.split_grid_to_6

        def half(grid, t):
            x = orig(grid, t)
            h = x.shape[2] // 2
            return torch.cat([x[:, :, :h] * 2 ** 0.5,
                              torch.zeros_like(x[:, :, h:])], dim=2)

        tr.split_grid_to_6 = half
        return lambda: setattr(tr, "split_grid_to_6", orig)
    if fault == "altered":
        opt = trainer.optimizer
        orig_step = opt.step
        leaf = trainer.mlp.output_linear.weight

        def doubled(*a, **k):
            before = leaf.detach().clone()
            out = orig_step(*a, **k)
            with torch.no_grad():
                leaf.add_(leaf - before)
            return out

        opt.step = doubled
        return lambda: None
    raise ValueError(f"no fault {fault!r}")


def setup(cell, seed, torch, device="cuda", tiny=False, fault=None,
          control=False):
    from contexture_nerf_tpu_torch.diffusion import schedulers as sch
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        Zero123PlusTeacher
    from contexture_nerf_tpu_torch.models.fields import NeRF2D
    from contexture_nerf_tpu_torch.models.textured_mesh import \
        TexturedMeshModel
    from contexture_nerf_tpu_torch.training import trainer as tr

    p = cell.params
    dev = torch.device(device)
    clock = common.Phases(torch, dev)
    torch.zeros(1, device=dev)
    clock("device start")
    cfg = common.train_config(cell, tiny, control)
    exact = bool(cfg.optim.exact_lattice_render)
    teacher = Zero123PlusTeacher(tiny=tiny, device="meta")
    if not tiny:
        common.check_unet(cell, teacher.unet_config)
    clock("teacher modules")
    tile = teacher.tile_px
    render_px = 96 if tiny else cfg.render.train_grid_size
    g = common.geometry(cfg, tile, render_px, dev, exact)
    clock("geometry")
    if dev.type == "cuda":
        # the peak from here on is the program's: the plain rasterizer's
        # buffers are the benchmark's own
        torch.cuda.reset_peak_memory_stats()
    specs = common.install_towers(teacher, TOWERS, seed, dev, teacher.dtype)
    teacher.alphas_cumprod = sch.make_alphas_cumprod(device=dev)
    teacher.ramping = torch.linspace(0.0, 1.0, teacher.ramping.shape[0],
                                     device=dev)
    mlp = NeRF2D(device="meta")
    W.install(mlp, W.make_mlp(W.spec(mlp), seed, dev), requires_grad=True)
    params0 = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    clock("weights")

    gen = torch.Generator(device=dev).manual_seed(W.tower_seed(seed, "inputs"))
    down = teacher.vae_config.downsample
    lat_c = teacher.vae_config.latent_channels
    ctx = teacher.unet_config.cross_attention_dim
    inputs = {
        "depth_grid": g["depth_grid"], "mask_grid": g["mask_grid"],
        "uv_grid_pts": g["uv_pts"], "edit_mask_pts": None,
        "cond_lat_pair": torch.randn((2, lat_c, tile // down, tile // down),
                                     generator=gen, device=dev
                                     ).to(teacher.dtype),
        "encoder_hidden_states": torch.randn(
            (2, cell.config["context_tokens"], ctx), generator=gen,
            device=dev).to(teacher.dtype),
        "tile_probs": torch.full((6,), 1.0 / 6.0, device=dev),
        "cache6": g["cache"], "bboxes6": g["bboxes6"]}
    mesh_model = None
    if exact:
        mesh_model = TexturedMeshModel(
            cfg.guide, render_grid_size=render_px,
            texture_resolution=cfg.guide.texture_resolution, cache_path=None,
            compute_dtype=tr.mlp_dtype(teacher.dtype, dev), device=dev,
            write_cache=False)
    draw_gen = torch.Generator(device=dev).manual_seed(
        W.tower_seed(seed, "draws"))
    trainer = tr.SDSTrainer(cfg, inputs, teacher=teacher, mlp=mlp, tiny=tiny,
                            device=dev, generator=draw_gen,
                            mesh_model=mesh_model, mesh=None)
    undo = plant(torch, trainer, tr, fault)
    clock("trainer")
    ts = ref.dreamtime_schedule(ref.alphas_cumprod("cpu"), p["iterations"])
    it = p["start"]
    beta1 = cfg.optim.sds_betas[0]
    draws, losses, fishers, grads1 = [], [], [], None
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
    params_n = {k: v.detach().clone() for k, v in mlp.named_parameters()}
    clock("first steps")
    work_counts = work.sds_step(
        common.unet_config(cell, tiny), common.vae_config(cell, tiny), tile,
        tile, exact, trainer.local_grad, cfg.optim.local_sds_margin_px,
        cfg.guide.texture_resolution)
    return SimpleNamespace(
        cell=cell, cfg=cfg, seed=seed, dev=dev, tiny=tiny, trainer=trainer,
        teacher=teacher, mesh_model=mesh_model, specs=specs, inputs=inputs,
        geometry=g, params0=params0, draws=draws, losses=losses,
        fishers=fishers, diagnostics={}, phases=clock.times,
        grads1=grads1, params_n=params_n, ts=ts, it=it, undo=undo,
        window_losses=[], window_peak=0, work=work_counts, exact=exact,
        tile=tile, setup_peak=(torch.cuda.max_memory_allocated()
                               if dev.type == "cuda" else 0))


def _step(state):
    _, loss, *_ = state.trainer.step(state.ts[state.it % len(state.ts)])
    if state.it % state.cell.params["log_every"] == 0:
        float(loss)
    state.it += 1
    return loss


def window(state, torch, seconds: float) -> dict:
    cuda = state.dev.type == "cuda"
    common.sync(torch, state.dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = state.window_losses
    while True:
        losses.append(_step(state))
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(torch, state.dev)
    dt = time.perf_counter() - t0
    state.window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    return {"sds_step_ms": dt * 1e3 / len(losses),
            "peak_mem_gib": state.window_peak / 2 ** 30}


def traced_window(state, torch) -> tracekit.Trace:
    from contexture_nerf_tpu_torch.diffusion import layers
    from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

    k = state.cell.params["trace_steps"]
    common.sync(torch, state.dev)
    t0 = time.perf_counter()
    for _ in range(k):
        state.window_losses.append(_step(state))
    common.sync(torch, state.dev)
    untraced_ms = (time.perf_counter() - t0) * 1e3 / k
    tch = state.teacher
    spans = tracekit.Spans(torch, tch, [tch.unet, tch.controlnet,
                                        tch.vae_encoder], GroupNormSiLU,
                           layers)
    try:
        events = tracekit.profile_units(
            torch, spans, k, lambda: state.window_losses.append(_step(state)))
    finally:
        spans.remove()
    state.window_peak = torch.cuda.max_memory_allocated()
    w = state.work
    return tracekit.Trace(events, k, dict(spans.calls),
                          {"unit_flops": w["flops"],
                           "mlp_flops": w["parts"]["mlp"]}, untraced_ms)


def counts(state, torch):
    """(steps attempted in the window, those whose loss is not finite)."""
    if not state.window_losses:
        return 0, 0
    ok = torch.isfinite(torch.stack(state.window_losses).float())
    return len(state.window_losses), int((~ok).sum())


def peak_bytes(state, torch) -> int:
    return max(state.setup_peak, state.window_peak)


def check(state, torch) -> dict:
    """Free the program, run the reference through the same steps from the
    same weights, inputs and draws, and compare: each step's Fisher
    divergence over the whole canvas (the teacher's v-prediction against
    the v-target), the first gradient and the parameters' change after the
    steps, leaf by leaf. Each step's loss (one tile's) is kept among the
    diagnostics: it separates the control from sound runs less than the
    Fisher divergence does."""
    cell, dev, tiny = state.cell, state.dev, state.tiny
    opt = state.cfg.optim
    state.undo()
    change_p = {n: state.params_n[n] - state.params0[n] for n in state.params0}
    state.trainer = state.teacher = state.mesh_model = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = torch.float32 if tiny else getattr(torch, cell.config["dtype"])
    ucfg, vcfg = common.unet_config(cell, tiny), common.vae_config(cell, tiny)
    with ref.exact_f32():
        with torch.device("meta"):
            mods = {"unet": rt.UNet2DCondition(ucfg),
                    "controlnet": rt.ControlNet(ucfg),
                    "vae_encoder": rt.Encoder(vcfg)}
        mods = common.reference_towers(torch, mods, state.specs, state.seed,
                                       dev, served)
        mlp = ref.NeRF2D().to(dev)
        W.install(mlp, {k: v.clone() for k, v in state.params0.items()},
                  requires_grad=True)
        g = state.geometry
        inputs = {"depth_grid": g["depth_grid"].float(),
                  "mask_grid": g["mask_grid"].float(),
                  "uv_pts": g["uv_pts"].float(),
                  "cond_lat_pair": state.inputs["cond_lat_pair"].float(),
                  "ehs": state.inputs["encoder_hidden_states"].float(),
                  "bboxes6": g["bboxes6"]}
        if state.exact:
            inputs.update(cache_uv=g["cache"][1], cache_mask=g["cache"][8])
        r = ref.SDSReference(
            (mods["unet"], mods["controlnet"], mods["vae_encoder"]), mlp,
            inputs, state.tile, vcfg, state.exact, bool(opt.local_sds_grad),
            int(opt.local_sds_margin_px), state.cfg.guide.texture_resolution,
            (opt.sds_lr, opt.sds_betas, opt.sds_eps))
        it = cell.params["start"]
        losses, fishers, grads1 = [], [], None
        for i, d in enumerate(state.draws):
            out = r.step(state.ts[it + i], d)
            losses.append(out["loss"])
            fishers.append(out["fisher"])
            if i == 0:
                grads1 = out["grads"]
        change_r = {n: q.detach() - state.params0[n]
                    for n, q in mlp.named_parameters()}

    def rel(p_, r_):
        return [abs(float(a) - b) / max(abs(b), 1e-30) for a, b in zip(p_, r_)]

    grad = common.leaf_gaps(state.grads1, grads1)
    change = common.leaf_gaps(change_p, change_r,
                              keep=common.moved_leaves(grads1))
    state.diagnostics = {
        "loss_gaps": rel(state.losses, losses),
        "fisher_gaps": rel(state.fishers, fishers),
        "grad_worst": max(grad, key=grad.get),
        "grad_median": sorted(grad.values())[len(grad) // 2],
        "change_worst": max(change, key=change.get),
        "change_median": sorted(change.values())[len(change) // 2]}
    values = {"fisher_gap": max(state.diagnostics["fisher_gaps"]),
              "grad_gap": max(grad.values()),
              "change_gap": max(change.values())}
    nan = float("nan")
    return {k: {"value": v, "limit": cell.limits.get(k, nan)}
            for k, v in values.items()}
