"""Build and bind the hand-written CUDA kernels under csrc/.

Each kernel source is compiled on its own by nvcc for sm_90a into a shared
library with a plain C interface, under build/torch_kernels/ at the root of
the checkout, and loaded with ctypes. The file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
Nothing here runs when the module is imported: the first call that needs a
kernel builds it (or `build_all` builds every one, in parallel).

Every wrapper adds one to `launch_counts[name]` where it launches its
kernel, and nowhere else, so a run can show which kernels it went through;
`launch_shapes` keeps the same launches by the call's sizes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> (source compiled, headers it includes)
SOURCES: Dict[str, tuple] = {
    "mlp_fwd": ("mlp_fwd.cu", ("mlp_common.cuh", "hopper.cuh")),
    "mlp_bwd": ("mlp_bwd.cu", ("mlp_common.cuh", "hopper.cuh")),
    "flash_attn": ("flash_attn.cu", ("hopper.cuh",)),
    "raster": ("raster.cu", ()),
    "groupnorm": ("groupnorm.cu", ("hopper.cuh",)),
    "texture": ("texture.cu", ()),
}

# launches per kernel, by the names chip_smoke.py reports
launch_counts: Dict[str, int] = {
    "mlp_fwd": 0, "mlp_bwd": 0,
    "flash_attn_single": 0, "flash_attn_two_source": 0, "raster": 0,
    "groupnorm": 0, "groupnorm_bwd": 0, "texture_fwd": 0, "texture_bwd": 0,
}

# the same launches by kernel and call sizes: (name, *sizes) -> launches
launch_shapes: Counter = Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


def count_launch(name: str, *sizes: int, n: int = 1) -> None:
    """Count n launches of kernel `name` at the call's `sizes`."""
    launch_counts[name] += n
    launch_shapes[(name, *sizes)] += n


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return exe


def _lib_path(name: str) -> Path:
    src, deps = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src,) + tuple(deps):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one library; returns (Popen, tmp path, final path)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, dict]:
    """Build every kernel library at once (one nvcc per source, started
    together). Returns {name: {"seconds", "log"}}; raises on a failed
    build."""
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in SOURCES}
    info = {}
    for n, s in started.items():
        log = _finish_build(n, s) if s is not None else \
            _lib_path(n).with_suffix(".log").read_text()
        info[n] = {"seconds": time.perf_counter() - t0, "log": log}
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, for a launcher."""
    return torch.cuda.current_stream(device).cuda_stream
