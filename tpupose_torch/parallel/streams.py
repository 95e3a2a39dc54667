"""Multi-stream tracking: the throughput mode.

Counterpart of `tpupose/parallel/streams.py`. The tracker is an O(1)-state
per-frame recurrence, so the card is filled with many independent video
streams at once: tracker state, cameras and detections get a leading
stream axis and `torch.func.vmap` runs `tracker_step` over it. The step
reads nothing on the host, so one batched step costs about the launches of
one stream's step, and the LAPs of all streams go to one launch of K3 per
call site (`ops.lap.masked_lap`'s vmap rule). `make_multistream_step_fn`
captures that step once per stream count as a CUDA graph and replays it
each frame (`runtime.graphs`), as the JAX package jits it. Over several
cards the stream axis is split over the mesh's 'data' ranks
(`shard_streams`), and each rank advances its own streams.
"""
from __future__ import annotations

from functools import partial

import torch

from tpupose_torch.geometry import CameraSet
from tpupose_torch.parallel.mesh import shard_batch
from tpupose_torch.pipeline.facade import resolve_device
from tpupose_torch.runtime.graphs import captured_step
from tpupose_torch.tracking.tracker import (
    TrackerConfig,
    TrackerState,
    init_state,
    tracker_step,
)


def _stack(tree, num_streams):
    """Every tensor of a NamedTuple with a leading stream axis (a copy per
    stream, so that a stream's state can be written on its own)."""
    return type(tree)(*(x[None].repeat((num_streams,) + (1,) * x.dim())
                        for x in tree))


def init_multistream_state(cfg: TrackerConfig, num_streams: int,
                           device=None) -> TrackerState:
    """TrackerState with a leading stream axis, on CUDA unless `device`
    says otherwise."""
    return _stack(init_state(cfg, resolve_device(device)), num_streams)


def broadcast_cameras(cams: CameraSet, num_streams: int) -> CameraSet:
    """Tile one rig across streams (streams may also use distinct rigs)."""
    return _stack(cams, num_streams)


def multistream_step(cfg: TrackerConfig, cams: CameraSet, state, dets, mask,
                     frame_ids):
    """vmapped tracker step.

    Args:
      cams: CameraSet with a leading stream axis on every field.
      state: TrackerState with a leading stream axis.
      dets: (S, C, D, J, 3); mask: (S, C, D); frame_ids: (S,) integer tensor.
    Returns:
      (new_state, FrameOutput), each with a leading stream axis.
    """
    return torch.func.vmap(partial(tracker_step, cfg))(cams, state, dets, mask,
                                                       frame_ids)


def captured_multistream_step(cfg: TrackerConfig, cams, state, dets, mask, frame_ids):
    """The process's captured `multistream_step` for `cfg` at these inputs'
    device, stream count, shapes and dtypes (`runtime.graphs.captured_step`):
    its `step` runs one frame, its `clip` F frames."""
    return captured_step(("multistream_step", cfg), partial(multistream_step, cfg), cams,
                         state, dets, mask, frame_ids)


def shard_streams(mesh, tree):
    """This rank's rows of the leading stream axis of every tensor in a
    stream-major tree (CameraSet, TrackerState, detections), on its
    device: its share of 'data' (`parallel.mesh.shard_batch`)."""
    return shard_batch(mesh, tree)


def make_multistream_step_fn(cfg: TrackerConfig, mesh=None, num_streams=None):
    """The multistream step for `cfg`: fn(cams, state, dets, mask,
    frame_ids) -> (state, FrameOutput), each with a leading stream axis.
    As the JAX package jits it, each input signature (device, stream count,
    shapes, dtypes) is captured once per process as a CUDA graph of
    `multistream_step` and replayed on every call
    (`runtime.graphs.CapturedStep.step`; on the CPU the same buffers run
    the eager vmapped step). What it returns is the caller's.

    With a mesh each rank calls the step on its own streams (`shard_streams`
    of the global ones, or `multihost.global_streams` of its own) and
    captures its own graph on its own card; nothing crosses cards.
    `num_streams`, the streams over all ranks, is then required: every
    input's leading size must be num_streams / data, and a mismatch raises
    naming the input, so that no rank silently runs the whole stream axis."""
    def step(cams, state, dets, mask, frame_ids):
        return captured_multistream_step(cfg, cams, state, dets, mask, frame_ids).step(
            cams, state, dets, mask, frame_ids)

    if mesh is None:
        return step
    if num_streams is None:
        raise TypeError("a step over a mesh needs num_streams, the streams over all ranks")
    d = mesh.shape["data"]
    if num_streams % d:
        raise ValueError(f"{num_streams} streams not divisible by {d} data ranks")
    local = num_streams // d

    def sharded(cams, state, dets, mask, frame_ids):
        leaves = ([(f"cams.{k}", v) for k, v in cams._asdict().items()]
                  + [(f"state.{k}", v) for k, v in state._asdict().items()]
                  + [("dets", dets), ("mask", mask), ("frame_ids", frame_ids)])
        for name, x in leaves:
            if x.dim() == 0 or x.shape[0] != local:
                raise ValueError(
                    f"{name} has leading size {tuple(x.shape[:1])}, not this rank's "
                    f"{local} of {num_streams} streams over {d} data ranks "
                    f"(shard the inputs with shard_streams)")
        return step(cams, state, dets, mask, frame_ids)

    return sharded
