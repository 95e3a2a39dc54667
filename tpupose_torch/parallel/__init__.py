"""Multi-stream throughput mode: S independent camera rigs (or clips) on one
card, stage A batched over every stream's frames and stage B advancing S
trackers in one vmapped step.

Counterpart of the single-device parts of `tpupose/parallel`
(`streams.py`, `throughput.py`). The mesh, multi-host and sharded parts
need `torch.distributed` and more than one card and are not ported yet:
`make_multistream_step_fn` raises for a mesh.
"""
from tpupose_torch.parallel.streams import (
    broadcast_cameras,
    init_multistream_state,
    make_multistream_step_fn,
    multistream_step,
)
from tpupose_torch.parallel.throughput import make_multistream_clip_fn

__all__ = [
    "broadcast_cameras",
    "init_multistream_state",
    "make_multistream_clip_fn",
    "make_multistream_step_fn",
    "multistream_step",
]
