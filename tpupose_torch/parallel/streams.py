"""Multi-stream tracking: the throughput mode.

Counterpart of `tpupose/parallel/streams.py`. The tracker is an O(1)-state
per-frame recurrence, so the card is filled with many independent video
streams at once: tracker state, cameras and detections get a leading
stream axis and `torch.func.vmap` runs `tracker_step` over it. The step
reads nothing on the host, so one batched step costs about the launches of
one stream's step, and the LAPs of all streams go to one launch of K3 per
call site (`ops.lap.masked_lap`'s vmap rule).
"""
from __future__ import annotations

from functools import partial

import torch

from tpupose_torch.geometry import CameraSet
from tpupose_torch.pipeline.facade import resolve_device
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


def make_multistream_step_fn(cfg: TrackerConfig, mesh=None):
    """The multistream step for `cfg`: fn(cams, state, dets, mask,
    frame_ids). The JAX package jits it and, with a mesh, shards the stream
    axis over devices; PyTorch runs eagerly, and streams sharded over cards
    are not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "streams sharded over a device mesh are not ported to "
            "tpupose_torch yet (ROADMAP.md, Queue 1 item 6)")
    return partial(multistream_step, cfg)
