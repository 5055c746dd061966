"""Start a function on n ranks with a deadline:
`run_ranks(n, function, device)`.

The ranks are torch.multiprocessing processes (spawned). Each sets
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
localhost, MASTER_PORT a free port), initialises the default group
(parallel/mesh.py `init_from_env`: NCCL on cuda:LOCAL_RANK, or gloo on the
CPU when the CPU is asked for), calls `function(device, **kwargs)` and
saves what it returns with torch.save into a temporary directory. A rank
that raises fails the launch (torch's ProcessRaisedException, with its
traceback); when the deadline passes, every rank still running is killed
and the launch raises.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(r, n, port, fn, device, kwargs, timeout_s, threads, out):
    import torch.distributed as dist

    from contexture_nerf_tpu_torch.parallel.mesh import init_from_env

    os.environ.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads))
    torch.set_num_threads(threads)
    dev = init_from_env(device, timeout_s=timeout_s)
    try:
        torch.save(fn(dev, **kwargs), Path(out) / f"rank{r}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn: Callable, device: str = "cpu",
              kwargs: Optional[Dict] = None, timeout_s: float = 300.0,
              threads: int = 1) -> List:
    """Run `fn` (a module-level function) on n ranks and return each
    rank's result, in rank order."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as out:
        ctx = mp.start_processes(
            _rank, args=(n, free_port(), fn, device, kwargs or {}, timeout_s,
                         threads, out), nprocs=n, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{fn.__name__} on {n} ranks: the "
                                       f"deadline of {timeout_s:.0f} s passed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
