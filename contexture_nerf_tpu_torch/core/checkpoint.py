"""Checkpoint and resume: the port's counterpart of
contexture_nerf_tpu/core/checkpoint.py (orbax there).

A checkpoint is one file, `iter_%06d` in the run's checkpoints/ directory:
a torch.save of {"params": the MLP's state_dict, "opt_state": Adam's
state_dict, "generator": the trainer's torch.Generator state, "iteration"}.
It is written to a temporary file and moved into place with os.replace, so
an interrupted save never leaves half a checkpoint under the final name. A
checkpoint of params and iteration only (the older format) restores too.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^iter_(\d{6})$")


def _host(tree):
    """The tensors of a nested dict/list on the CPU (a checkpoint restores
    on any device)."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def save(path: Path, params: Dict[str, torch.Tensor],
         opt_state: Optional[Dict[str, Any]] = None, iteration: int = 0,
         generator_state: Optional[torch.Tensor] = None) -> None:
    path = Path(path)
    payload: Dict[str, Any] = {"params": _host(params),
                               "iteration": int(iteration)}
    if opt_state is not None:
        payload["opt_state"] = _host(opt_state)
    if generator_state is not None:
        payload["generator"] = generator_state.detach().cpu()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def restore(path: Path) -> Dict[str, Any]:
    """The saved dict, tensors on the CPU. Only tensors and plain
    containers are unpickled (weights_only)."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def latest_iteration(ckpt_dir: Path) -> Optional[int]:
    """The iteration of the newest iter_XXXXXX checkpoint in a directory."""
    its = [int(m.group(1)) for p in Path(ckpt_dir).glob("iter_*")
           if (m := _NAME.match(p.name))]
    return max(its) if its else None
