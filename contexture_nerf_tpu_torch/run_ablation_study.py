"""Guidance ablation: the 16 runs of guidance_scale_i x guidance_scale_t
over {1, 3, 5, 7}^2 with individual control of the conditions; the
counterpart of run_ablation_study.py.

    python -m contexture_nerf_tpu_torch.run_ablation_study

Each run is composed as a YAML config in a temporary file and painted by
`python -m contexture_nerf_tpu_torch.run_contexture --config_path=<it>`
in a process of its own; a run that fails does not stop the others.
`run_one` paints one of them in this process instead.
"""

from __future__ import annotations

import itertools
import subprocess
import sys
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import yaml

from contexture_nerf_tpu_torch.core.config import load_config
from contexture_nerf_tpu_torch.training.trainer import ConTEXTure

BASE = {
    "log": {"exp_name": "ablation"},
    "guide": {
        "text": "A photo of a nascar racing car",
        "shape_path": "shapes/nascar.obj",
        "use_zero123plus": True,
    },
}
SCALES = [1, 3, 5, 7]


def configs() -> Iterator[Tuple[int, int, Dict]]:
    """(guidance_scale_i, guidance_scale_t, the run's config dict) of each
    of the 16 runs, in order."""
    for gi, gt in itertools.product(SCALES, SCALES):
        cfg = yaml.safe_load(yaml.safe_dump(BASE))
        cfg["guide"]["guidance_scale_i"] = gi
        cfg["guide"]["guidance_scale_t"] = gt
        cfg["guide"]["individual_control_of_conditions"] = True
        cfg["log"]["exp_name"] = f"ablation_gi{gi}_gt{gt}"
        yield gi, gt, cfg


def write_config(cfg: Dict) -> str:
    """The run's config as a YAML file of its own; returns its path."""
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        yaml.safe_dump(cfg, f)
        return f.name


def run_one(gi: int, gt: int, overrides: Optional[Dict[str, dict]] = None,
            device="cuda", tiny_models: bool = False, **models) -> ConTEXTure:
    """Paint the run (gi, gt) in this process: its YAML, with `overrides`
    ({section: {key: value}}) over it, loaded as the CLI loads it;
    `models` (teacher, mlp, diffusion) go to ConTEXTure in place of new
    random ones. Returns the run."""
    cfg = next(c for i, t, c in configs() if (i, t) == (gi, gt))
    for section, values in (overrides or {}).items():
        cfg.setdefault(section, {}).update(values)
    run = ConTEXTure(load_config([f"--config_path={write_config(cfg)}"]),
                     tiny_models=tiny_models, device=device, **models)
    run.paint()
    return run


def main(argv: Optional[List[str]] = None,
         runner=subprocess.run) -> List[str]:
    """Write each run's YAML and paint it with `runner` (a
    subprocess.run-like callable) in a process of its own; `argv` is
    passed on to each run's CLI. Returns the YAML paths."""
    paths = []
    for gi, gt, cfg in configs():
        path = write_config(cfg)
        print(f"=== ablation gi={gi} gt={gt} -> {path}")
        runner([sys.executable, "-m",
                "contexture_nerf_tpu_torch.run_contexture",
                f"--config_path={path}"] + list(argv or []), check=False)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
