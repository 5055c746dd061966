"""How far the fast knobs move a paint's outputs; counterpart of
tools/knob_quality.py.

Paints the same production-scale run (spot_quick_test.yaml at a 1200^2
train grid, 1024^2 eval grid and texture, 8 eval frames) four times, each
through the port's CLI in a process of its own:

- knobq_default: `optim.local_sds_grad=false` and
  `optim.precompute_uv_embedding=false`, the reference-exact path (the
  config's defaults turn both knobs on);
- knobq_knobs: both knobs true;
- knobq_emb_only: local_sds_grad false, precompute_uv_embedding true; the
  same function as the defaults, so any drift it shows is noise;
- knobq_seed1: the defaults at seed + 1, the chaos floor of an equally
  valid run.

Then it compares each run with the default one: PSNR of the texture
atlases (results/eval_texture_atlas.png) and of the exported albedos,
per-frame PSNR of the eval turntables (results/eval_video_*.gif), and the
last SDS losses of metrics.json. Each run's two knobs as its config.yaml
resolved them go into the result too, and the tool exits 1 when the
defaults and the knobs runs resolved to the same two values (the
comparison would hold a run against itself).

    python -m contexture_nerf_tpu_torch.tools.knob_quality [--iters 500]
        [--seed 0] [--exp-root DIR] [--out FILE] [--skip TAGS]
        [--compare-only]

The runs go under --exp-root (build/knob_quality by default) and the JSON
to --out (knob_quality.json there). With random towers the PSNR only shows
that the tool runs; it measures the knobs' drift only with real weights.
The reference's tool paints its defaults run with no knob flags, so under
the config's defaults it compares two runs of the same path.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DEFAULT_ROOT = REPO / "build" / "knob_quality"
KNOBS = ("local_sds_grad", "precompute_uv_embedding")  # config section optim


def paint_argv(exp_root: Path, exp_name: str, iters: int, seed: int,
               knobs) -> list:
    """The CLI arguments of one paint: production render and texture
    scale, where the knobs' timings were taken and where local_sds_grad's
    receptive-field cut acts on 320^2 tiles of the 960x640 grid. `knobs`
    sets both KNOBS (a bool) or each in turn (a pair of bools)."""
    if isinstance(knobs, bool):
        knobs = (knobs, knobs)
    argv = [
        "--config_path=configs/text_guided/spot_quick_test.yaml",
        f"--log.exp_root={exp_root}",
        f"--log.exp_name={exp_name}",
        f"--optim.sds_iterations={iters}",
        f"--optim.seed={seed}",
        "--render.train_grid_size=1200",
        "--render.eval_grid_size=1024",
        "--guide.texture_resolution=1024",
        "--log.full_eval_size=8",
        f"--optim.checkpoint_interval={iters}",
    ]
    return argv + [f"--optim.{k}={str(v).lower()}"
                   for k, v in zip(KNOBS, knobs)]


def resolved_knobs(exp: Path) -> dict:
    """{knob: value} of KNOBS as the run resolved them (its config.yaml)."""
    import yaml

    optim = yaml.safe_load((exp / "config.yaml").read_text())["optim"]
    return {k: optim[k] for k in KNOBS}


def config_diff(exp_a: Path, exp_b: Path) -> dict:
    """{"section.key": (a, b)} for each config key on which two runs'
    config.yaml differ, the run's name (log.exp_name) aside."""
    import yaml

    a, b = (yaml.safe_load((e / "config.yaml").read_text())
            for e in (exp_a, exp_b))
    return {f"{sec}.{k}": (a[sec].get(k), b[sec].get(k))
            for sec in a for k in a[sec].keys() | b[sec].keys()
            if a[sec].get(k) != b[sec].get(k)
            and f"{sec}.{k}" != "log.exp_name"}


def _run_paint(exp_root: Path, exp_name: str, iters: int, seed: int,
               knobs) -> float:
    """One paint through `python -m contexture_nerf_tpu_torch
    .run_contexture` in a process of its own (its output to
    <exp_root>/<exp_name>.log); returns its wall seconds."""
    cmd = [sys.executable, "-m", "contexture_nerf_tpu_torch.run_contexture",
           *paint_argv(exp_root, exp_name, iters, seed, knobs)]
    exp_root.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with open(exp_root / f"{exp_name}.log", "w") as fh:
        subprocess.run(cmd, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
                       check=True)
    return time.time() - t0


def _load_png(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"),
                      dtype=np.float32) / 255.0


def _load_gif_frames(path: Path) -> list:
    from PIL import Image, ImageSequence
    im = Image.open(path)
    return [np.asarray(f.convert("RGB"), dtype=np.float32) / 255.0
            for f in ImageSequence.Iterator(im)]


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else float(-10.0 * np.log10(mse))


def compare(exp_a: Path, exp_b: Path) -> dict:
    """Run b against run a: the atlases' and albedos' PSNR, the eval
    turntables' per-frame PSNR (mean over the finite ones, and min), and
    each run's mean SDS loss over its last 10 entries, last view
    consistency and entry count."""
    out: dict = {}
    atlas_a = exp_a / "results" / "eval_texture_atlas.png"
    atlas_b = exp_b / "results" / "eval_texture_atlas.png"
    out["texture_atlas_psnr_db"] = round(_psnr(_load_png(atlas_a),
                                               _load_png(atlas_b)), 2)
    albedo_a = exp_a / "mesh" / "albedo.png"
    albedo_b = exp_b / "mesh" / "albedo.png"
    if albedo_a.exists() and albedo_b.exists():
        out["albedo_psnr_db"] = round(_psnr(_load_png(albedo_a),
                                            _load_png(albedo_b)), 2)

    gifs_a = sorted((exp_a / "results").glob("eval_video_*.gif"))
    gifs_b = sorted((exp_b / "results").glob("eval_video_*.gif"))
    if gifs_a and gifs_b:
        fa, fb = _load_gif_frames(gifs_a[0]), _load_gif_frames(gifs_b[0])
        per_frame = [round(_psnr(x, y), 2) for x, y in zip(fa, fb)]
        finite = [p for p in per_frame if np.isfinite(p)]
        out["eval_render_psnr_db"] = {
            "per_frame": per_frame,
            "mean": round(float(np.mean(finite)), 2) if finite
            else float("inf"),
            "min": min(per_frame),
        }

    losses = {}
    for tag, exp in (("default", exp_a), ("knobs", exp_b)):
        m = json.loads((exp / "metrics.json").read_text())  # list of dicts
        sds = [r["sds_loss"] for r in m if "sds_loss" in r]
        vc = [r["view_consistency"] for r in m if "view_consistency" in r]
        losses[tag] = {
            "final_10_mean": round(float(np.mean(sds[-10:])), 6)
            if sds else None,
            "final_view_consistency": round(vc[-1], 6) if vc else None,
            "records": len(m),
        }
    out["sds_loss"] = losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exp-root", type=Path, default=DEFAULT_ROOT)
    ap.add_argument("--out", type=Path, default=None,
                    help="the JSON result (default: knob_quality.json under "
                    "--exp-root)")
    ap.add_argument("--compare-only", action="store_true",
                    help="skip the paints, just re-compare existing runs")
    ap.add_argument("--skip", default="",
                    help="comma-separated run tags to skip painting")
    args = ap.parse_args(argv)
    root = args.exp_root.resolve()

    runs = {
        "knobq_default": dict(seed=args.seed, knobs=False),
        "knobq_knobs": dict(seed=args.seed, knobs=True),
        "knobq_emb_only": dict(seed=args.seed, knobs=(False, True)),
        "knobq_seed1": dict(seed=args.seed + 1, knobs=False),
    }
    skip = set(filter(None, args.skip.split(",")))
    wall = {}
    if not args.compare_only:
        for name, spec in runs.items():
            if name in skip or (root / name / "mesh" / "albedo.png").exists():
                continue
            wall[name + "_s"] = round(_run_paint(
                root, name, args.iters, spec["seed"], spec["knobs"]), 1)

    exp = {k: root / k for k in runs}
    result = {
        "what": "default vs (local_sds_grad + precompute_uv_embedding) at "
                "production render scale, with bit-identity and chaos-floor "
                "controls",
        "iters": args.iters,
        "seed": args.seed,
        "wall_clock": wall,
        "resolved_knobs": {k: resolved_knobs(e) for k, e in exp.items()
                           if (e / "config.yaml").exists()},
    }
    for key, other in (("default_vs_knobs", "knobq_knobs"),
                       ("default_vs_emb_only_bit_identity_control",
                        "knobq_emb_only"),
                       ("default_vs_seed1_chaos_floor", "knobq_seed1")):
        if (exp[other] / "metrics.json").exists():
            result[key] = compare(exp["knobq_default"], exp[other])
    out = args.out or root / "knob_quality.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result))
    knobs = result["resolved_knobs"]
    if {"knobq_default", "knobq_knobs"} <= knobs.keys() \
            and knobs["knobq_default"] == knobs["knobq_knobs"]:
        print(f"knob_quality: knobq_default and knobq_knobs resolved to the "
              f"same knobs {knobs['knobq_default']}: their comparison holds "
              f"a run against itself", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
