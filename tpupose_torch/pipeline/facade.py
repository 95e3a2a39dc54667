"""End-to-end pipeline facade: detect -> crop -> 2D pose -> decode -> track.

Counterpart of `tpupose/pipeline/facade.py` (the clip path and the replay
step). Stage A (`_clip_detections`) runs YOLOv3 and HRNet over every frame
of a clip as one batch; stage B runs the tracker over the frames. The
pipeline lives on one device, CUDA unless the caller passes another.
"""
from __future__ import annotations

import numpy as np
import torch

from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.models.hrnet import HRNet, HRNetConfig, normalize_image
from tpupose_torch.models.yolov3 import (
    YOLOv3,
    YoloConfig,
    detect_people,
    prepare_yolo_images,
)
from tpupose_torch.ops.heatmap import decode_heatmaps_auto, expand_box_to_aspect
from tpupose_torch.ops.image import crop_and_resize
from tpupose_torch.tracking.tracker import (
    FrameOutput,
    TrackerConfig,
    TrackerState,
    init_state,
    track_clip,
    tracker_step,
)


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when None; raises if CUDA is asked for and absent
    (the port never moves to the CPU on its own)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpupose_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return device


def _clip_detections(det_cfg, pose_cfg, tcfg, detector, pose_model, images,
                     compute_dtype=torch.bfloat16):
    """Batched detect -> crop -> pose -> decode for N images, padded to the
    tracker's max_dets.

    Args:
      images: (N, H, W, 3) uint8 / float RGB (NHWC).
      compute_dtype: the networks' compute dtype (bf16 serving, f32 for
        reference runs); the preprocessing is bf16 either way.
    Returns:
      dets: (N, D, J, 3) (x, y, score); mask: (N, D) bool.
    """
    in_h, in_w = pose_cfg.input_size
    n, h, w, _ = images.shape
    # bf16 preprocessing, as the JAX package: uint8 values are exact in
    # bf16 and the resample products accumulate in f32.
    x = images.to(torch.bfloat16) / 255.0
    ximg = prepare_yolo_images(det_cfg, x)
    boxes, _, valid = detect_people(detector, det_cfg, ximg, (h, w), compute_dtype)
    k = boxes.shape[1]
    eboxes = expand_box_to_aspect(boxes.reshape(-1, 4), in_h / in_w)
    crops = crop_and_resize(x, eboxes.reshape(n, k, 4), (in_h, in_w))
    crops = normalize_image(crops.reshape(n * k, in_h, in_w, 3), value_scale=1.0)
    heat = pose_model(crops.permute(0, 3, 1, 2).contiguous(), compute_dtype)  # f32 NCHW
    kps = decode_heatmaps_auto(heat, eboxes.contiguous(),
                               refine=pose_cfg.decode_refine)
    kps = kps.reshape(n, k, pose_cfg.num_joints, 3)
    d = tcfg.max_dets
    if k >= d:
        return kps[:, :d], valid[:, :d]
    dets = kps.new_zeros((n, d, tcfg.num_joints, 3))
    dets[:, :k] = kps
    mask = valid.new_zeros((n, d))
    mask[:, :k] = valid
    return dets, mask


class Pipeline:
    """Camera rig, models, tracker configuration and state on one device.

    Args:
      cams: CameraSet (moved to `device`).
      tracker_cfg: TrackerConfig.
      det_cfg, detector: YoloConfig and YOLOv3 module (optional for replay).
      pose_cfg, pose_model: HRNetConfig and HRNet module (optional).
      state: initial TrackerState (default: empty).
      device: torch device; None means CUDA, which must be present.
      compute_dtype: the networks' compute dtype (bf16 serving default).
    """

    def __init__(self, cams: CameraSet, tracker_cfg: TrackerConfig,
                 det_cfg: YoloConfig | None = None,
                 detector: YOLOv3 | None = None,
                 pose_cfg: HRNetConfig | None = None,
                 pose_model: HRNet | None = None,
                 state: TrackerState | None = None, device=None,
                 compute_dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.cams = cams.to(self.device)
        self.tracker_cfg = tracker_cfg
        self.det_cfg = det_cfg
        self.pose_cfg = pose_cfg
        self.detector = None if detector is None else detector.to(self.device).eval()
        self.pose_model = None if pose_model is None else pose_model.to(self.device).eval()
        self.state = (init_state(tracker_cfg, self.device) if state is None
                      else state.to(self.device))

    @staticmethod
    def camera_set_from_parameter_dict(camera_parameter, width, height,
                                       num_cameras=None) -> CameraSet:
        """Reference `GetCameraParameters`: a dict with 'P', 'K', 'RT'."""
        P = np.asarray(camera_parameter["P"], np.float32)
        K = np.asarray(camera_parameter["K"], np.float32)
        RT = np.asarray(camera_parameter["RT"], np.float32)
        if num_cameras is not None:
            P, K, RT = P[:num_cameras], K[:num_cameras], RT[:num_cameras]
        return make_camera_set(P, K, RT, width, height)

    def track_restart(self):
        self.state = init_state(self.tracker_cfg, self.device)

    def _as_input(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    def person_track(self, frame_id, detections, det_mask) -> FrameOutput:
        """One tracker step on (C, D, J, 3) detections and a (C, D) mask;
        returns the FrameOutput and updates self.state."""
        with torch.inference_mode():
            self.state, out = tracker_step(
                self.tracker_cfg, self.cams, self.state,
                self._as_input(detections, torch.float32),
                self._as_input(det_mask, torch.bool), int(frame_id))
        return out

    def process_clip_nn(self, clip_images):
        """Stage A only: ((F, C, D, J, 3) detections, (F, C, D) mask) for a
        (F, C, H, W, 3) uint8 clip."""
        clip = self._as_input(clip_images)
        f, c, h, w, _ = clip.shape
        with torch.inference_mode():
            dets, mask = _clip_detections(
                self.det_cfg, self.pose_cfg, self.tracker_cfg, self.detector,
                self.pose_model, clip.reshape(f * c, h, w, 3), self.compute_dtype)
        d = dets.shape[1]
        return (dets.reshape(f, c, d, self.tracker_cfg.num_joints, 3),
                mask.reshape(f, c, d))

    def process_clip(self, frame_ids, clip_images):
        """Batched NN over the whole clip (stage A), then the tracker over
        its frames (stage B).

        Args:
          frame_ids: (F,) ints.
          clip_images: (F, C, H, W, 3) uint8 RGB.
        Returns:
          (FrameOutput stacked over F, detections, det_mask).
        """
        dets, mask = self.process_clip_nn(clip_images)
        frame_ids = self._as_input(frame_ids, torch.int32)
        with torch.inference_mode():
            self.state, outs = track_clip(self.tracker_cfg, self.cams,
                                          self.state, dets, mask, frame_ids)
        return outs, dets, mask

    def harvest(self, out: FrameOutput, frame_id, timestamp=None):
        """FrameOutput -> the reference's artifacts: (N, 3, 17) poses, track
        ids and per-camera 2D annotations."""
        valid = out.valid.cpu().numpy()
        ids = out.track_id.cpu().numpy()[valid]
        poses3d = out.pose3d.cpu().numpy()[valid]
        pts3d = [np.transpose(p) for p in poses3d]
        annotations = []
        pose2d = out.pose2d.cpu().numpy()[valid]
        now = out.pose2d_now.cpu().numpy()[valid]
        for i, tid in enumerate(ids):
            for cid in range(pose2d.shape[1]):
                if now[i, cid]:
                    annotations.append({
                        "timestamp": timestamp if timestamp is not None else frame_id,
                        "cid": cid,
                        "pid": int(tid),
                        "pose": pose2d[i, cid, :, :2],
                        "scores": pose2d[i, cid, :, 2],
                    })
        return np.asarray(pts3d), ids, annotations
