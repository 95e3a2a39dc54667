"""Scale-out over processes: `torch.distributed` set-up and global meshes.

Counterpart of `tpupose/parallel/multihost.py`. The JAX package runs one
process per host over all its devices; PyTorch's idiom, and what this
workload needs, is one process per card: stage B is the host's issue of
small launches, so one host thread feeding several cards would issue
several times the launches.

* `initialize` forms the process group: NCCL between cards (the rank's
  card is `process_id % torch.cuda.device_count()`), gloo on the CPU. It
  takes the coordinator's `tcp://host:port` (or JAX's bare `host:port`) or
  a `file://` path every rank can reach, and a finite timeout, so that a
  missing peer raises instead of hanging.
* Stream parallelism keeps the frame loop on each card: the only
  collectives are metric reductions (`all_hosts_metric`) and, when
  training, gradient and batch-statistics reductions.
* Each rank feeds only its own streams (`process_stream_slice`,
  `global_streams`), so no frame crosses cards.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from tpupose_torch.parallel.mesh import BACKENDS, Mesh, make_mesh, require_group, tree_map
from tpupose_torch.pipeline.facade import resolve_device

#: How long a rank waits for its peers (rendezvous and each collective)
#: before it raises.
TIMEOUT = datetime.timedelta(minutes=5)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None) -> None:
    """Join (or form) the process group of `num_processes` ranks as rank
    `process_id`, on CUDA unless `device` says otherwise. A no-op for a
    single process with no coordinator, as in the JAX package."""
    if coordinator_address is None and (num_processes or 1) == 1:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and "
                         "process_id to form a group")
    device = resolve_device(device)
    address = (coordinator_address if "://" in coordinator_address
               else "tcp://" + coordinator_address)
    kwargs = {}
    if device.type == "cuda":
        index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(BACKENDS[device.type], init_method=address,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **kwargs)


def global_mesh(model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over every rank of the group, on the
    device type its backend serves. Ranks are ordered by process id, so
    'data' indexes processes (groups of `model` of them)."""
    require_group()
    device = {b: d for d, b in BACKENDS.items()}[dist.get_backend()]
    return make_mesh(model=model, device=device)


def process_stream_slice(total_streams: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """[start, end) of the streams this rank owns: an even share by its
    'data' index (ranks that share it hold the same streams), or by its
    rank over the whole group when no mesh is given (one process alone owns
    them all). `total_streams` must divide evenly, so that every rank holds
    the same per-stream shapes."""
    if mesh is not None:
        n, i = mesh.shape["data"], mesh.data_index
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if total_streams % n:
        raise ValueError(f"{total_streams} streams not divisible by {n} data ranks")
    per = total_streams // n
    return i * per, (i + 1) * per


def global_streams(mesh: Mesh, local_batch):
    """This rank's streams as tensors on its device.

    `local_batch` is a tree (NamedTuples, tuples, dicts) of host numpy
    arrays whose axis 0 holds this rank's streams only (those of
    `process_stream_slice`); the global stream axis is their concatenation
    over the 'data' ranks, and no rank sees another's frames."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=mesh.device), local_batch)


def all_hosts_metric(mesh: Mesh, fn):
    """A per-shard metric summed over 'data': fn(local streams) -> a scalar
    contribution; the returned callable gives every rank the same global
    scalar (a tensor on its device)."""
    def metric(tree):
        value = torch.as_tensor(fn(tree), device=mesh.device).clone()
        dist.all_reduce(value, op=dist.ReduceOp.SUM, group=mesh.data_group)
        return value

    return metric
