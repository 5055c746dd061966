"""What every cell shares: finding a cell's files by name, the checks on
the environment, the device record and the result line.

A cell is `cells/<name>.json` (its config, traffic kind and parameters,
limits and `why`); its configuration `configs/<config>.json`; its traffic
driver `traffic/<kind>.py`; each per-layer metric a reader
`metrics/<metric>.py` with `read(trace) -> float | None`. `BENCHMARK.json`
at the root of the checkout says which metrics a cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "contexture_nerf_tpu")


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for every compiler the
    program may use (the hand kernels build into build/torch_kernels/ on
    their own), and no JAX from libraries that would load it."""
    return {"TRITON_CACHE_DIR": str(root / "build" / "triton_cache"),
            "TORCH_EXTENSIONS_DIR": str(root / "build" / "torch_extensions"),
            "USE_FLAX": "0"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell found by name under `bench_dir`, with its configuration, its
    traffic driver and the metrics BENCHMARK.json gives it."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR,
                 benchmark: Optional[dict] = None):
        self.name = name
        self.dir = bench_dir
        self.spec = load_json(bench_dir / "cells" / f"{name}.json")
        self.config = load_json(bench_dir / "configs"
                                / f"{self.spec['config']}.json")
        self.traffic = self.spec["traffic"]
        self.params = self.spec.get("params", {})
        self.limits = self.spec.get("limits", {})
        self.benchmark = benchmark if benchmark is not None else load_json(
            bench_dir.parent / "BENCHMARK.json")

    def driver(self) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{self.traffic}.py",
                           f"portbench_traffic_{self.traffic}")

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.benchmark["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[dict]:
        return [m for m in self.benchmark["per_layer"] if self._applies(m)]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_record(torch, peak_bytes: int, count: int = 1,
                  busy_s: Optional[float] = None,
                  window_s: Optional[float] = None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        d["busy_s"] = busy_s
        d["window_s"] = window_s
    return d


def require_cards(torch, count: int) -> Optional[str]:
    """Why this machine cannot run the cell, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: this benchmark runs on " \
               "the card only"
    if torch.cuda.device_count() < count:
        return (f"the cell needs {count} cards, torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def check_lines(check: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in check.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, check: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)


def apply_env(env: Dict[str, str]) -> None:
    for k, v in env.items():
        os.environ[k] = v
    Path(env["TRITON_CACHE_DIR"]).mkdir(parents=True, exist_ok=True)
