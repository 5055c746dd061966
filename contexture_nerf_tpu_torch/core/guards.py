"""Numerical guards: the port's counterpart of
contexture_nerf_tpu/core/guards.py.

  - check_finite(tree, name): a host-side check over the tensors of a
    nested dict, list or tuple (tests, debugging);
  - finite_or_zero(x): non-finite values replaced by 0 (the SDS gradient's
    nan_to_num);
  - enable_debug_nans(): PyTorch's anomaly mode, which raises at the
    backward op that first makes a NaN.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def check_finite(tree, name: str = "tensor") -> None:
    for i, leaf in enumerate(_leaves(tree)):
        ok = bool(torch.isfinite(leaf).all()) if torch.is_tensor(leaf) \
            else bool(np.all(np.isfinite(np.asarray(leaf))))
        if not ok:
            raise ValueError(
                f"{name}[leaf {i}] contains NaNs or infinite values")


def finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def enable_debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
