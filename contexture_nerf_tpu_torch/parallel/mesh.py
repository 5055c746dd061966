"""The device mesh over torch.distributed; counterpart of
contexture_nerf_tpu/parallel/mesh.py.

The JAX package runs one program over a mesh of devices and lets XLA place
each array (GSPMD). The port runs one process a rank (torchrun, or
parallel/launch.py) and says where every collective goes. Axes, as in the
reference:
  views - the data axis: the student's query rows of the SDS step and the
          eval turntable frames;
  tp    - tensor parallelism of the diffusion towers (parallel/tp.py);
  sp    - sequence parallelism of the teacher's attention (parallel/ring.py).

Every wrapper of a collective here adds one to `collective_counts[kind]`,
so a run can count the collectives a step makes.
"""

from __future__ import annotations

import datetime
import math
import os
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# collectives issued through this package, by kind
collective_counts: Counter = Counter()

_MESHES: Dict[Tuple, object] = {}


def world_size() -> int:
    """Ranks of the default group; 1 when torch.distributed is not
    initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this process writes a run's files: rank 0, or the only
    process."""
    return rank() == 0


def init_from_env(device="cuda", timeout_s: float = 600.0) -> torch.device:
    """Initialise the default group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on
    cuda:LOCAL_RANK, or gloo on the CPU when `device` is the CPU. Returns
    the rank's device. A failed NCCL start raises: nothing retries on gloo
    or on the CPU."""
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=timeout, device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", timeout=timeout)
    else:
        raise ValueError(f"unsupported device {device}")
    return dev


def device_type() -> str:
    """The mesh's device type: cuda under NCCL, cpu under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(axis_sizes: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("views",)):
    """A DeviceMesh over the initialised default group; a 1-D 'views' mesh
    over every rank by default. The sizes' product must equal the world
    size. The same request returns the same mesh (its groups are made
    once)."""
    n = world_size()
    sizes = tuple(axis_sizes) if axis_sizes is not None else (n,)
    if math.prod(sizes) != n:
        raise AssertionError((sizes, n))
    from torch.distributed.device_mesh import init_device_mesh

    key = (device_type(), sizes, tuple(axis_names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(key[0], sizes,
                                        mesh_dim_names=tuple(axis_names))
    return _MESHES[key]


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along `axis`; 1 without a mesh or that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without a mesh or that
    axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def views_sharding(mesh=None, axis: str = "views"):
    """The placement of a tensor whose leading dimension is split over
    `axis`: Shard(0)."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def replicated(mesh=None):
    """The placement of a tensor every rank holds whole: Replicate()."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def block(x: torch.Tensor, n: int, r: int, dim: int = 0) -> torch.Tensor:
    """The r-th of n contiguous blocks of x along `dim`."""
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k)


def shard_leading_axis(tree, mesh, axis: str = "views"):
    """Every tensor of a (dict / list / tuple) tree whose leading dimension
    the axis divides, cut to this rank's contiguous block of it; any other
    tensor (or leaf) left whole, as the reference replicates it."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] % n == 0:
            return block(x, n, r)
        return x

    return place(tree)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order of `group`."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    collective_counts["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, in place."""
    dist.all_reduce(x, group=group)
    collective_counts["all_reduce"] += 1
    return x


class _GatherRows(torch.autograd.Function):
    """All-gather along `dim` whose backward keeps this rank's block of the
    gradient: the loss after it is replicated, so every rank holds the same
    gradient of the gathered tensor and no collective is needed."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (dist.get_world_size(group), dist.get_rank(group), dim)
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r, dim = ctx.conf
        return block(g, n, r, dim).contiguous(), None, None


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Autograd-aware all-gather of blocks along `dim` for a replicated
    loss (`_GatherRows`)."""
    return _GatherRows.apply(x, group, dim)
