"""ConTEXTure-NeRF in PyTorch for one NVIDIA H100.

The JAX package `contexture_nerf_tpu` is the reference this package is held
against; each module here sits at the same relative path as its counterpart
there. Nothing here imports JAX or the JAX package. The kernels that the
reference wrote in Pallas are hand-written CUDA C++ for sm_90a under `csrc/`,
compiled at first use into `build/torch_kernels/` and bound with ctypes
(`ops/_build.py`).
"""

import contextlib
import time
from typing import Dict, Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    only on an explicit request (the tests pass device="cpu"). Raises when
    the card is asked for and there is none: no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "contexture_nerf_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def phase(timings: Optional[Dict[str, float]], name: str, device):
    """Wall milliseconds of a block added to timings[name], a CUDA device
    synchronised at both ends (nothing is timed when timings is None)."""
    if timings is None:
        yield
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
