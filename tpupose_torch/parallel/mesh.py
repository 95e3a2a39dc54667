"""Meshes of ranks, sharding specs, and counted (differentiable) collectives.

Counterpart of `tpupose/parallel/mesh.py`, over `torch.distributed`: one
process per card (a rank) where the JAX package has one program over a
host's devices. The axes are the JAX package's:

* 'data': batch and stream parallelism, the scaling axis of this workload
  (each rank tracks its own streams, or trains on its own crops);
* 'model': the conv output channels, over which `make_sharded_train_step`
  splits the parameters and their optimizer state.

A spec is what JAX's `PartitionSpec` holds: a tuple naming, per dimension,
the mesh axis it is split over (None where it is not); `()` is
replicated. The backend follows the mesh's device, with no fallback: a
CUDA mesh needs a NCCL process group, a CPU mesh a gloo one.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpupose_torch.models.train import named_trained_tensors
from tpupose_torch.pipeline.facade import resolve_device

AXES = ("data", "model")
#: The process group's backend for a mesh on each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: Collectives issued through this module, by kind, forward and backward
#: (reset freely; read by chip_smoke.py). A captured training step counts
#: those its graph holds at each replay (`runtime.graphs.CapturedUpdate`).
all_reduces = 0
all_gathers = 0
reduce_scatters = 0
#: The counters' names.
COUNTERS = ("all_reduces", "all_gathers", "reduce_scatters")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh over every rank of the process group, as
    this rank sees it."""

    device_mesh: object          # torch.distributed.device_mesh.DeviceMesh
    shape: dict                  # {"data": d, "model": m}, as JAX's mesh.shape
    data_group: object           # the ranks that share this rank's 'model' index
    model_group: object          # the ranks that share this rank's 'data' index
    data_index: int              # this rank's coordinate on 'data'
    model_index: int             # this rank's coordinate on 'model'
    device: torch.device         # this rank's card, or the CPU


def require_group():
    """Raise unless a default process group exists."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call "
            "tpupose_torch.parallel.multihost.initialize(...) on every rank first")


def make_mesh(data: int | None = None, model: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh over every rank, on CUDA unless `device`
    says otherwise (`init_device_mesh`; every rank calls it). Needs an
    initialized group of data x model ranks whose backend serves `device`."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    require_group()
    backend = dist.get_backend()
    if backend != BACKENDS[device.type]:
        raise RuntimeError(f"a {device.type} mesh needs the {BACKENDS[device.type]} "
                           f"backend; the process group uses {backend}")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(device.type, (data, model), mesh_dim_names=AXES)
    d, m = dm.get_coordinate()
    return Mesh(dm, {"data": data, "model": model}, dm.get_group("data"),
                dm.get_group("model"), d, m, device)


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> tuple:
    """Split one dimension over 'data', replicate the rest."""
    return tuple("data" if i == axis else None for i in range(ndim))


def replicated(mesh: Mesh) -> tuple:
    return ()


def tree_map(fn, tree):
    """fn over every leaf of nested NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows along axis 0 of every tensor or array in `batch`
    (its `data_index`-th of `data` equal parts), copied to its device."""
    d, i = mesh.shape["data"], mesh.data_index

    def local(x):
        x = torch.as_tensor(x)
        if x.shape[0] % d:
            raise ValueError(f"leading size {x.shape[0]} does not split over {d} data ranks")
        k = x.shape[0] // d
        return x[i * k:(i + 1) * k].to(mesh.device, copy=True)

    return tree_map(local, batch)


def conv_param_sharding(mesh: Mesh, model_or_named_tensors, min_channels: int = 16) -> dict:
    """The JAX package's tensor-parallel rule, in PyTorch's layout.

    A conv weight (O, I, kh, kw) with O divisible by the 'model' axis and
    O >= min_channels is split on its output channels, dim 0; so is a 1-D
    tensor of such a length (a BN's weight, bias and running statistics,
    which `models.train.trained_tensors` trains). Everything else is
    replicated. Takes a module (its `models.train.named_trained_tensors`)
    or {name: tensor}; returns {name: spec}."""
    named = (dict(named_trained_tensors(model_or_named_tensors))
             if isinstance(model_or_named_tensors, torch.nn.Module)
             else dict(model_or_named_tensors))
    mp = mesh.shape["model"]

    def rule(x):
        if x.dim() in (1, 4) and x.shape[0] % mp == 0 and x.shape[0] >= min_channels:
            return ("model",) + (None,) * (x.dim() - 1)
        return ()

    return {name: rule(x) for name, x in named.items()}


def all_reduce_sum_(x, group):
    """SUM all-reduce of `x` in place over `group`, counted in
    `all_reduces`; returns `x`."""
    global all_reduces
    all_reduces += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_into_(out, x, group):
    """Every rank's `x` over `group` into `out` (contiguous, d times x's
    size; its r-th part is group rank r's), counted in `all_gathers`;
    returns `out`."""
    global all_gathers
    all_gathers += 1
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return out


def reduce_scatter_sum_into_(out, x, group):
    """The SUM over `group` of every rank's `x` (contiguous, d times out's
    size), scattered: `out` gets the r-th part of the sum on group rank r;
    counted in `reduce_scatters`; returns `out`."""
    global reduce_scatters
    reduce_scatters += 1
    dist.reduce_scatter_tensor(out.view(-1), x.view(-1), op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
        return all_gather_into_(out, x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        return reduce_scatter_sum_into_(grad.new_empty(grad.shape[1:]), grad, ctx.group), None


def all_gather(x, group):
    """(d, *x.shape): `x` of each of the d ranks of `group`, in group rank
    order; differentiable: its backward is a SUM reduce-scatter of the
    incoming gradient, so that each rank's input gets the gradient of every
    rank's loss with respect to its row."""
    return _AllGather.apply(x, group)
