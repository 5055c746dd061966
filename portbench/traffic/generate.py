"""Traffic `generate`: back-to-back Zero123++ ground-truth grids, each a
whole job a user waits for (`Zero123PlusPipeline.generate`: the
conditioning, `steps` EulerAncestral steps of the CFG teacher, the VAE
decode; no blending, no inpainting).

Set-up makes the towers' weights, a smooth condition image of `cond_px`
squared and the torus's depth grid from the seed, and warms the shapes up
with one `warmup_steps`-step grid. The window runs grids until `--seconds`
have passed, then syncs. Each grid's draws are made by the program's own
`draw_generation` from the run's generator and handed to `generate`, which
is what `generate` does when it is given none. The benchmark records, for
job number `check_job` (or the last, if fewer ran), what each EulerAncestral
step took and gave (the program's own latents and v-predictions: Python
references, no device work). Once the window has closed the reference
follows that job step by step from the program's own state: its
conditioning, its v-prediction at each of the program's latents, its Euler
update of each, and its decode of the program's final latent. Followed
freely over 28 ancestral steps, bf16's and the int8 control's grids land
equally far from the f32 reference's (PERF.md), so each stage is compared
alone. The traced window runs `trace_jobs` grids after as many untraced
ones.

Parameters: steps, guidance_scale, height, width, cond_px, warmup_steps,
trace_jobs, check_job (a list: the job is drawn from it by the seed),
control_towers (the towers besides the teacher's that the control runs
through the program's W8A8 path).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

from portbench import common, tracekit
from portbench import weights as W
from portbench.reference import generate as rg
from portbench.reference import sds as ref
from portbench.reference import towers as rt
from portbench.work import counts as work

TOWERS = ("unet", "controlnet", "vae_encoder", "text_encoder",
          "vision_encoder", "vae_decoder")


def plant(torch, pipe, fault):
    """A fault under the timed path, for the benchmark's own tests:
    'altered' (the teacher's v-prediction with one channel negated where it
    is made), 'half_batch' (the CFG's conditional branch left out: the
    unconditional one alone). Returns an undo function."""
    if fault is None:
        return lambda: None
    if fault == "altered":
        orig = pipe._cfg_v_pred

        def altered(*a, **k):
            v = orig(*a, **k).clone()
            v[:, 0] = -v[:, 0]
            return v

        pipe._cfg_v_pred = altered
        return lambda: None
    if fault == "half_batch":
        orig = pipe._cfg_core

        def uncond_only(*a, **k):
            v_u, _ = orig(*a, **k)
            return [v_u, v_u]

        pipe._cfg_core = uncond_only
        return lambda: None
    raise ValueError(f"no fault {fault!r}")


def condition_image(torch, gen, px: int, device):
    """A smooth (1, 3, px, px) image in [-1, 1]: 8x8 normal draws resized
    up, through tanh."""
    low = torch.randn((1, 3, 8, 8), generator=gen, device=device)
    return torch.tanh(ref.resize_linear(low, (px, px)))


def setup(cell, seed, torch, device="cuda", tiny=False, fault=None,
          control=False):
    from contexture_nerf_tpu_torch.diffusion import schedulers as sch
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        Zero123PlusPipeline

    p = cell.params
    dev = torch.device(device)
    clock = common.Phases(torch, dev)
    torch.zeros(1, device=dev)
    clock("device start")
    cfg = common.train_config(cell, tiny, False)
    pipe = Zero123PlusPipeline(tiny=tiny, device="meta")
    if not tiny:
        common.check_unet(cell, pipe.unet_config)
    clock("teacher modules")
    tile = pipe.tile_px
    H, W_ = (3 * tile, 2 * tile) if tiny else (p["height"], p["width"])
    cond_px = tile if tiny else p["cond_px"]
    g = common.geometry(cfg, tile, 96 if tiny else cfg.render.train_grid_size,
                        dev, False)
    clock("geometry")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    specs = common.install_towers(pipe, TOWERS, seed, dev, pipe.dtype)
    acp = sch.make_alphas_cumprod(device=dev)
    pipe.alphas_cumprod = pipe.euler.alphas_cumprod = \
        pipe.ddpm.alphas_cumprod = acp
    pipe.ramping = torch.linspace(0.0, 1.0, pipe.ramping.shape[0], device=dev)
    if control:
        # the program's own W8A8 path: the teacher's towers as the
        # configuration's control states, and the VAE's resnets and
        # resamplers through the same switch
        from contexture_nerf_tpu_torch.diffusion.layers import set_quant

        pipe.set_int8(False, True)
        for tower in p["control_towers"]:
            set_quant(getattr(pipe, tower), True)
    undo = plant(torch, pipe, fault)
    clock("weights")
    gen = torch.Generator(device=dev).manual_seed(W.tower_seed(seed, "inputs"))
    cond = condition_image(torch, gen, cond_px, dev)
    depth = g["depth_grid"]
    job_gen = torch.Generator(device=dev).manual_seed(
        W.tower_seed(seed, "draws"))
    record_steps(pipe)
    state = SimpleNamespace(
        cell=cell, seed=seed, dev=dev, tiny=tiny, pipe=pipe, specs=specs,
        cond=cond, depth=depth, gen=job_gen, H=H, W=W_, undo=undo,
        steps=2 if tiny else p["steps"], jobs=[], kept=None,
        check_job=p["check_job"][seed % len(p["check_job"])],
        window_peak=0, phases=clock.times)
    _job(state, steps=2 if tiny else p["warmup_steps"], keep=False)
    clock("warm-up grid")
    state.jobs = []
    state.setup_peak = (torch.cuda.max_memory_allocated()
                        if dev.type == "cuda" else 0)
    from portbench.reference.generate import (CLIPTextConfig,
                                              CLIPVisionConfig)
    tc = CLIPTextConfig.tiny() if tiny else CLIPTextConfig()
    vc = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig()
    if tiny:
        vc.projection_dim = tc.hidden_size
    state.work = work.grid(common.unet_config(cell, tiny),
                           common.vae_config(cell, tiny), tc, vc, H, W_,
                           cond_px, state.steps)
    state.clip_configs = (tc, vc)
    return state


def record_steps(pipe):
    """Wrap the program's EulerAncestral step so that, while
    `pipe.euler.recording` is a list, each step's (v-prediction, latent in,
    latent out) is appended to it."""
    euler = pipe.euler
    orig = euler.step
    euler.recording = None

    def step(model_output, step_index, sample, sigmas, noise):
        out = orig(model_output, step_index, sample, sigmas, noise)
        if euler.recording is not None:
            euler.recording.append((model_output, sample, out))
        return out

    euler.step = step


def _job(state, steps=None, keep=True):
    """One grid through the program; keeps the output, and the draws and
    the steps of the job that is to be checked."""
    pipe, p = state.pipe, state.cell.params
    steps = steps or state.steps
    check = keep and len(state.jobs) <= state.check_job
    pipe.euler.recording = [] if check else None
    d = pipe.draw_generation(tuple(state.cond.shape[2:]), steps, state.H,
                             state.W, state.gen)
    img = pipe.generate(state.cond, state.depth, num_inference_steps=steps,
                        guidance_scale=p["guidance_scale"], height=state.H,
                        width=state.W, draws=d)
    if check:
        state.kept = (d, img, pipe.euler.recording)
    pipe.euler.recording = None
    if keep:
        state.jobs.append(img)
    return img


def window(state, torch, seconds: float) -> dict:
    cuda = state.dev.type == "cuda"
    common.sync(torch, state.dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = 0
    while True:
        _job(state)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(torch, state.dev)
    dt = time.perf_counter() - t0
    state.window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    return {"job_s": dt / n, "peak_mem_gib": state.window_peak / 2 ** 30}


def traced_window(state, torch) -> tracekit.Trace:
    from contexture_nerf_tpu_torch.diffusion import layers
    from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU

    k = state.cell.params["trace_jobs"]
    common.sync(torch, state.dev)
    t0 = time.perf_counter()
    for _ in range(k):
        _job(state)
    common.sync(torch, state.dev)
    untraced_ms = (time.perf_counter() - t0) * 1e3 / k
    pipe = state.pipe
    spans = tracekit.Spans(torch, pipe, [getattr(pipe, t) for t in TOWERS],
                           GroupNormSiLU, layers)
    try:
        events = tracekit.profile_units(torch, spans, k,
                                        lambda: _job(state))
    finally:
        spans.remove()
    state.window_peak = torch.cuda.max_memory_allocated()
    return tracekit.Trace(events, k, dict(spans.calls),
                          {"unit_flops": state.work["flops"]}, untraced_ms,
                          sub_units=k * state.steps)


def counts(state, torch):
    """(grids attempted in the window, those with a pixel that is not
    finite)."""
    bad = sum(int(not bool(torch.isfinite(img).all())) for img in state.jobs)
    return len(state.jobs), bad


def peak_bytes(state, torch) -> int:
    return max(state.setup_peak, state.window_peak)


def _gap(a, b) -> float:
    """‖a - b‖ / ‖b‖ in f64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def check(state, torch) -> dict:
    """Free the program and follow the kept job with the reference, step by
    step from the program's own state (its f32 conditioning made anew from
    the condition image and the draws): `step_gap`, the worst gap between
    the program's latent after a step and the reference's step (its own
    v-prediction and Euler update) from the program's latent before it,
    the program's first latent against the draws' scaled one among them;
    `image_gap`, the gap between the program's grid and the reference's
    decode of the program's final latent."""
    cell, dev, tiny = state.cell, state.dev, state.tiny
    state.undo()
    draws, img_p, steps = state.kept
    draws = {k: v.float() for k, v in draws.items()}
    steps = [(v.float(), a.float(), b.float()) for v, a, b in steps]
    img_p = img_p.float()
    state.pipe = state.kept = None
    state.jobs = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = torch.float32 if tiny else getattr(torch, cell.config["dtype"])
    ucfg, vcfg = common.unet_config(cell, tiny), common.vae_config(cell, tiny)
    tc, vc = state.clip_configs
    gs = cell.params["guidance_scale"]
    with ref.exact_f32():
        with torch.device("meta"):
            mods = {"unet": rt.UNet2DCondition(ucfg),
                    "controlnet": rt.ControlNet(ucfg),
                    "vae_encoder": rt.Encoder(vcfg),
                    "text_encoder": rg.CLIPTextModel(tc),
                    "vision_encoder": rg.CLIPVisionModelWithProjection(vc),
                    "vae_decoder": rt.Decoder(vcfg)}
        towers = common.reference_towers(torch, mods, state.specs,
                                         state.seed, dev, served)
        with torch.no_grad():
            acp = ref.alphas_cumprod(dev)
            ramping = torch.linspace(0.0, 1.0, tc.max_positions, device=dev)
            cond_lat_pair, ehs = rg.conditioning(
                towers, state.cond, draws["eps_cond"], draws["eps_neg"],
                ramping)
            lat0 = draws["latents"]
            emb = ref.hint_embedding(towers["controlnet"], state.depth,
                                     (lat0.shape[2], lat0.shape[3]))
            ts, sigmas = rg.sigmas_for(acp, state.steps)
            v_gaps = []
            step_gaps = [_gap(steps[0][1], lat0 * sigmas[0])]
            for i, (t, (v_p, lat_in, lat_out)) in enumerate(zip(ts, steps)):
                v_r = rg.teacher_v(towers, acp, lat_in, t, sigmas[i],
                                   cond_lat_pair, ehs, emb,
                                   draws["write_neg"][i],
                                   draws["write_cond"][i], gs)
                v_gaps.append(_gap(v_p, v_r))
                step_gaps.append(_gap(lat_out, rg.euler_step(
                    lat_in, v_r, sigmas[i], sigmas[i + 1],
                    draws["step"][i])))
            img_r = rg.decode(towers, steps[-1][2], vcfg)
    state.diagnostics = {"v_gaps": v_gaps, "step_gaps": step_gaps}
    values = {"step_gap": max(step_gaps), "image_gap": _gap(img_p, img_r)}
    nan = float("nan")
    return {k: {"value": v, "limit": cell.limits.get(k, nan)}
            for k, v in values.items()}
