"""Multi-stream throughput pipeline.

Counterpart of `tpupose/parallel/throughput.py`: S independent camera
systems (several studios, or several clips of one) through the two-stage
clip pipeline. Stage A is the facade's own `_clip_detections` (bf16
preprocessing, bf16 or int8 networks, the K1 decode) over chunks of frames
of every stream at once; stage B advances the S trackers together, one
replay a frame of the captured vmapped `tracker_step`
(`parallel.streams.multistream_step`, `runtime.graphs`).
Over several cards each rank calls the clip function on its own streams
(`parallel.shard_streams` or `multihost.global_streams`); it needs nothing
else, since no stream's frames or state cross cards.
"""
from __future__ import annotations

import torch

from tpupose_torch.models.hrnet import HRNetConfig
from tpupose_torch.models.yolov3 import YoloConfig
from tpupose_torch.parallel.streams import captured_multistream_step
from tpupose_torch.pipeline.facade import _clip_detections, needs_hrnet
from tpupose_torch.tracking.tracker import TrackerConfig
from tpupose_torch.utils import timing


def _auto_chunk(s: int, f: int, c: int, target_images: int = 160) -> int:
    """Frames per stage-A chunk so each chunk batches ~`target_images`
    images: the batch of the facade's 32-frame, 5-view clip. Must divide
    F; falls back to no chunking otherwise."""
    cf = max(1, round(target_images / (s * c)))
    while cf > 1 and f % cf:
        cf -= 1
    return cf


def make_multistream_clip_fn(det_cfg: YoloConfig, pose_cfg: HRNetConfig,
                             tcfg: TrackerConfig, image_hw=None,
                             chunk_frames=None):
    """Build the multi-stream clip function.

    Returns fn(detector, pose_model, cams_s, states_s, clip, frame_ids)
    where cams_s / states_s have a leading stream axis, clip is
    (S, F, C, H, W, 3) uint8 and frame_ids is (S, F), all on the models'
    device. It returns the new states and a FrameOutput with (S, F, ...)
    fields. The detector and pose model are float (bf16 folded) or int8
    (`quantize_convs`, `Pipeline.quantize_models`) modules.

    Stage A runs over chunks of `chunk_frames` frames of every stream
    (`_auto_chunk` when None; no chunking when it does not divide F), so
    the live intermediates are one chunk's. Chunking is exact: every
    stage-A op is per image. `image_hw` is accepted as in the JAX package
    and ignored: the geometry comes from the clip's shape. HRNet only:
    another pose net raises (`facade.needs_hrnet`).
    """
    del image_hw
    needs_hrnet(pose_cfg, "the multi-stream clip function")

    def fn(detector, pose_model, cams_s, states_s, clip, frame_ids):
        s, f, c, h, w, _ = clip.shape
        cf = chunk_frames if chunk_frames is not None else _auto_chunk(s, f, c)
        if f % cf:
            cf = f
        d, j = tcfg.max_dets, tcfg.num_joints
        with torch.inference_mode(), timing.clip():
            dets, mask = [], []
            for k in range(0, f, cf):
                dd, mm = _clip_detections(
                    det_cfg, pose_cfg, tcfg, detector, pose_model,
                    clip[:, k:k + cf].reshape(s * cf * c, h, w, 3))
                dets.append(dd.reshape(s, cf, c, d, j, 3))
                mask.append(mm.reshape(s, cf, c, d))
            # frame-major (F, S, ...), as the step's clip replays them
            dets = torch.cat(dets, dim=1).transpose(0, 1)
            mask = torch.cat(mask, dim=1).transpose(0, 1)
            frame_ids = torch.as_tensor(frame_ids).transpose(0, 1)
            states_s, outs = captured_multistream_step(
                tcfg, cams_s, states_s, dets[0], mask[0], frame_ids[0]).clip(
                cams_s, states_s, dets, mask, frame_ids, span="stage_b.clip")
        return states_s, type(outs)(*(x.transpose(0, 1) for x in outs))

    return fn
