"""Parallelism: meshes of ranks, sharding specs, the multi-stream
throughput mode.

Counterpart of `tpupose/parallel`, over `torch.distributed` with one
process per card. Axes: 'data' (batch and stream parallelism, the scaling
axis of this workload) and 'model' (the conv output channels, over which
`models.train.make_sharded_train_step` splits parameters and optimizer
state). `multihost` forms the process group (NCCL on cards, gloo on the
CPU). S independent camera rigs (or clips) run on one card through
`make_multistream_clip_fn`, stage A batched over every stream's frames and
stage B advancing the S trackers in one vmapped step; over several cards
each rank calls it on its own streams (`shard_streams`,
`multihost.global_streams`), and nothing crosses cards in the frame loop.
"""
from tpupose_torch.parallel.mesh import (
    conv_param_sharding,
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from tpupose_torch.parallel import multihost
from tpupose_torch.parallel.streams import (
    broadcast_cameras,
    init_multistream_state,
    make_multistream_step_fn,
    multistream_step,
    shard_streams,
)
from tpupose_torch.parallel.throughput import make_multistream_clip_fn

__all__ = [
    "multihost",
    "conv_param_sharding",
    "data_sharding",
    "make_mesh",
    "replicated",
    "shard_batch",
    "broadcast_cameras",
    "init_multistream_state",
    "make_multistream_clip_fn",
    "make_multistream_step_fn",
    "multistream_step",
    "shard_streams",
]
