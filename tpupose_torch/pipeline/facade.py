"""End-to-end pipeline facade: detect -> crop -> 2D pose -> decode -> track.

Counterpart of `tpupose/pipeline/facade.py`: the clip path, the staged API
(`person_detect`, `person_pose_detect`, `person_track`, `process_frame`,
`process_clips_nn`) and int8 serving (`quantize_models` with its drift
self-check). Stage A (`_clip_detections`) runs YOLOv3 and HRNet over every
frame of a clip as one batch; stage B runs the tracker over the frames, on
CUDA as a captured graph of the tracker step replayed each frame
(`tracking.tracker.make_step_fn`, `track_clip`). The pipeline lives on one
device, CUDA unless the caller passes another.

Stage A runs channels-last from the frames to the heatmaps, the layout of
the JAX package's NHWC stage A (`ops.layout`): `Pipeline` restrides its
models' conv weights once (`models.layers.to_channels_last`, when it takes
the models, after `pack_models` and after `quantize_models`), and the
networks get channels-last views of the NHWC images and crops, so no layer
copies a layout. The heatmaps are made NCHW-contiguous once for the decode
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from tpupose_torch.geometry import CameraSet, make_camera_set
from tpupose_torch.models.hrnet import HRNet, HRNetConfig, normalize_image
from tpupose_torch.models.layers import to_channels_last
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
    make_step_fn,
    track_clip,
)


# Fewest sample frames for which int8 activation-scale calibration and the
# drift self-check are trusted without a warning.
MIN_CALIB_SAMPLES = 8


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
    n, h, w, _ = images.shape
    # bf16 preprocessing, as the JAX package: uint8 values are exact in
    # bf16 and the resample products accumulate in f32.
    x = images.to(torch.bfloat16) / 255.0
    ximg = prepare_yolo_images(det_cfg, x)
    boxes, _, valid = detect_people(detector, det_cfg, ximg, (h, w), compute_dtype)
    k = boxes.shape[1]
    eboxes, crops = _pose_crops(pose_cfg, x, boxes)
    heat = pose_model(crops, compute_dtype)  # f32, in the crops' layout
    kps = decode_heatmaps_auto(heat.contiguous(), eboxes, refine=pose_cfg.decode_refine)
    kps = kps.reshape(n, k, pose_cfg.num_joints, 3)
    d = tcfg.max_dets
    if k >= d:
        return kps[:, :d], valid[:, :d]
    dets = kps.new_zeros((n, d, tcfg.num_joints, 3))
    dets[:, :k] = kps
    mask = valid.new_zeros((n, d))
    mask[:, :k] = valid
    return dets, mask


def _box_iou(box, others):
    """IoU of one (4,) xyxy box against (M, 4) boxes (numpy)."""
    x1 = np.maximum(box[0], others[:, 0])
    y1 = np.maximum(box[1], others[:, 1])
    x2 = np.minimum(box[2], others[:, 2])
    y2 = np.minimum(box[3], others[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = np.clip(box[2] - box[0], 0, None) * np.clip(box[3] - box[1], 0, None)
    b = np.clip(others[:, 2] - others[:, 0], 0, None) * np.clip(
        others[:, 3] - others[:, 1], 0, None)
    return inter / np.maximum(a + b - inter, 1e-9)


def _pose_crops(pose_cfg, x, boxes):
    """(N, H, W, 3) bf16 frames in [0, 1] and (N, K, 4) boxes -> the
    aspect-expanded (N*K, 4) boxes and the (N*K, 3, h, w) normalized crops
    HRNet reads, a channels-last view of the NHWC crops."""
    in_h, in_w = pose_cfg.input_size
    n, k = boxes.shape[:2]
    eboxes = expand_box_to_aspect(boxes.reshape(-1, 4), in_h / in_w)
    crops = crop_and_resize(x, eboxes.reshape(n, k, 4), (in_h, in_w))
    crops = normalize_image(crops.reshape(n * k, in_h, in_w, 3), value_scale=1.0)
    return eboxes.contiguous(), crops.permute(0, 3, 1, 2)


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

    The models are moved to `device` and their conv weights restrided to
    channels-last in place (`models.layers.to_channels_last`), the layout
    stage A serves in.
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
        self.detector = (None if detector is None
                         else to_channels_last(detector.to(self.device).eval()))
        self.pose_model = (None if pose_model is None
                           else to_channels_last(pose_model.to(self.device).eval()))
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

    def pack_models(self):
        """Width-pack the pose model's high-resolution branch
        (`ops.packing.pack_hrnet_branch0`): branch 0's activations move as
        (N, 2C, H, W/2) through convs with structural zeros, an exact
        reparameterization in bf16 and int8. Call after `quantize_models`
        or on the folded float model; idempotent. The pipeline keeps no
        compiled programs, so nothing built for the unpacked model
        outlives the swap. Whether it pays on the card is measured by
        `chip_smoke.py` phase 16; nothing calls it by default."""
        import dataclasses

        from tpupose_torch.ops.packing import pack_hrnet_branch0

        if self.pose_cfg is None or self.pose_cfg.pack_branch0:
            return
        self.pose_model = to_channels_last(pack_hrnet_branch0(self.pose_model))
        self.pose_cfg = dataclasses.replace(self.pose_cfg, pack_branch0=True)

    # -- int8 serving ------------------------------------------------------------

    def quantize_models(self, sample_images, qat_steps=0, qat_lr=1e-5,
                        qat_batch=8, qat_log=None, check_px=2.5,
                        on_drift="escalate", escalate_steps=900,
                        box_lost_gate=0.25):
        """Switch both backbones to int8 serving, after a drift self-check.

        Calibrates the activation scales by running the real preprocess ->
        detect -> crop path on `sample_images` ((N, H, W, 3) uint8 RGB
        frames, ideally from the deployment scenes) in the pipeline's
        compute dtype, then replaces `detector` and `pose_model` with int8
        copies (`tpupose_torch.models.quantize`); every later call runs
        them.

        `qat_steps > 0` replaces plain PTQ with label-free distill-QAT
        (`quantize.distill_qat`): each backbone's fake-quant copy trains for
        that many straight-through steps (Adam at `qat_lr`) to match its own
        float outputs on the calibration inputs, split into batches of
        `qat_batch`, then is requantized. On the card each QAT step
        replays a CUDA graph after its warm-ups (a short last batch is a
        second graph; see `distill_qat`). `qat_log(step, loss)` reports
        progress. Serving speed is the same: the served modules have the
        same int8 structure.

        Self-check (on unless `check_px=None`): the decoded keypoints of the
        int8 pose model are compared with the float model's on the
        calibration crops, and the int8 detector's boxes with the float
        detector's. If the median keypoint shift exceeds `check_px` px, or
        more than `box_lost_gate` of the float boxes have no IoU >= 0.5
        int8 counterpart, `on_drift` decides:

          * ``"escalate"`` (default): print the measured drift, re-run as
            distill-QAT with `escalate_steps` steps, and check again; raise
            `QuantizationDriftError` if it still fails (with `qat_steps > 0`
            there is nothing to escalate to, and it raises at once);
          * ``"raise"``: raise `QuantizationDriftError`;
          * ``"warn"``: print the measured drift and keep the int8 models.

        `last_quant_report` holds the numbers of the last check, also when
        it raised.
        """
        from tpupose_torch.models.quantize import (
            QuantizationDriftError,
            distill_qat,
            hrnet_skip_ids,
            quantize_hrnet,
            quantize_yolo,
            yolo_skip_ids,
        )

        if on_drift not in ("escalate", "raise", "warn"):
            raise ValueError(f"on_drift must be escalate/raise/warn, "
                             f"got {on_drift!r}")

        def batched(arr):
            m = max(1, min(qat_batch, arr.shape[0]))
            return [arr[i:i + m] for i in range(0, arr.shape[0], m)]

        det_f, pose_f = self.detector, self.pose_model
        x = self._as_input(sample_images)
        n, h, w, _ = x.shape
        if n < MIN_CALIB_SAMPLES:
            print(
                f"WARNING: int8 calibration + self-check running on only "
                f"{n} sample frame(s) (< {MIN_CALIB_SAMPLES}); the "
                "activation scales AND the drift check may not represent "
                "the deployment scenes — pass more frames "
                "(--int8-calib >= 8)"
            )
        dt = self.compute_dtype
        with torch.inference_mode():
            # calibrate on the same bf16 preprocessing as the clip program;
            # the float models' boxes, crops and keypoints are the pose
            # calibration input and the self-check's baseline in one pass
            xf = x.to(torch.bfloat16) / 255.0
            ximg = prepare_yolo_images(self.det_cfg, xf)
            boxes, _, valid = detect_people(det_f, self.det_cfg, ximg, (h, w), dt)
            eboxes, crops = _pose_crops(self.pose_cfg, xf, boxes)
            det_in = ximg.permute(0, 3, 1, 2)  # channels-last, as served

        def apply(model, batch):
            return model(batch, dt)

        def quantize_both(steps):
            if steps > 0:
                det_q = distill_qat(apply, det_f, batched(det_in), steps=steps, lr=qat_lr,
                                    skip_ids=yolo_skip_ids(det_f, self.det_cfg),
                                    log=qat_log)
                pose_q = distill_qat(apply, pose_f, batched(crops), steps=steps, lr=qat_lr,
                                     skip_ids=hrnet_skip_ids(pose_f), log=qat_log)
            else:
                det_q = quantize_yolo(det_f, self.det_cfg, det_in, dt)
                pose_q = quantize_hrnet(pose_f, self.pose_cfg, crops, compute_dtype=dt)
            return det_q, pose_q

        det_q, pose_q = quantize_both(qat_steps)

        if check_px is not None:
            report = self._quant_self_check(det_f, pose_f, det_q, pose_q,
                                            ximg, (h, w), crops, eboxes, valid)
            failed = (report["kps_median_px"] > check_px
                      or report["box_lost_frac"] > box_lost_gate)
            msg = ("int8 self-check: keypoint shift median "
                   f"{report['kps_median_px']:.2f} px / p95 "
                   f"{report['kps_p95_px']:.2f} px vs bf16 (gate "
                   f"{check_px} px); boxes lost "
                   f"{report['box_lost_frac'] * 100:.1f}% (gate "
                   f"{box_lost_gate * 100:.0f}%) "
                   f"[checked on {n} frames / {crops.shape[0]} crops]")
            if failed and on_drift == "escalate" and qat_steps == 0:
                print(f"{msg} -> FAILED; escalating to label-free "
                      f"distill-QAT ({escalate_steps} steps, the remedy "
                      "measured at W48 scale — docs/PERF.md)")
                det_q, pose_q = quantize_both(escalate_steps)
                report = self._quant_self_check(det_f, pose_f, det_q, pose_q,
                                                ximg, (h, w), crops, eboxes, valid)
                failed = (report["kps_median_px"] > check_px
                          or report["box_lost_frac"] > box_lost_gate)
                msg = ("int8 self-check after distill-QAT: keypoint "
                       "shift median "
                       f"{report['kps_median_px']:.2f} px / p95 "
                       f"{report['kps_p95_px']:.2f} px; boxes lost "
                       f"{report['box_lost_frac'] * 100:.1f}%")
            self.last_quant_report = report
            if failed and on_drift in ("raise", "escalate"):
                raise QuantizationDriftError(
                    f"{msg} — refusing to serve a provably-drifted int8 "
                    "model. Remedies: more/representative --int8-calib "
                    "frames, --qat-steps 900, or on_drift='warn' to "
                    "override."
                )
            print(msg + (" -> FAILED (continuing: on_drift='warn')"
                         if failed else " -> ok"))

        self.detector = to_channels_last(det_q)
        self.pose_model = to_channels_last(pose_q)

    def _quant_self_check(self, det_f, pose_f, det_q, pose_q, ximg, hw, crops,
                          eboxes, valid):
        """Decoded-keypoint and box drift of the int8 models against the
        float models on the calibration inputs. Returns summary floats."""
        dt = self.compute_dtype
        with torch.inference_mode():
            def decode(model):
                return decode_heatmaps_auto(model(crops, dt).contiguous(), eboxes,
                                            refine=self.pose_cfg.decode_refine)

            kps_ref = decode(pose_f).cpu().numpy()  # (n*k, J, 3)
            kps_q = decode(pose_q).cpu().numpy()
            boxes_ref, _, valid_ref = detect_people(det_f, self.det_cfg, ximg, hw, dt)
            boxes_q, _, valid_q = detect_people(det_q, self.det_cfg, ximg, hw, dt)
        vmask = valid.cpu().numpy().reshape(-1)
        shift = np.linalg.norm(kps_q[..., :2] - kps_ref[..., :2], axis=-1)[vmask]
        if shift.size == 0:
            # no people in the calibration frames: keypoint drift unknowable
            kps_median = kps_p95 = 0.0
            print("int8 self-check: WARNING — no detections in the "
                  "calibration frames; keypoint drift not assessed. "
                  "Use frames that contain people.")
        else:
            kps_median = float(np.median(shift))
            kps_p95 = float(np.percentile(shift, 95))
        br = boxes_ref.cpu().numpy().astype(np.float32)
        bq = boxes_q.cpu().numpy().astype(np.float32)
        vr = valid_ref.cpu().numpy()
        vq = valid_q.cpu().numpy()
        lost = total = 0
        for i in range(br.shape[0]):
            for j in np.flatnonzero(vr[i]):
                total += 1
                if not vq[i].any():
                    lost += 1
                    continue
                if _box_iou(br[i, j], bq[i][vq[i]]).max() < 0.5:
                    lost += 1
        return {
            "kps_median_px": kps_median,
            "kps_p95_px": kps_p95,
            "kps_n": int(shift.size),
            "box_lost_frac": (lost / total) if total else 0.0,
            "box_n": total,
        }

    # -- staged API --------------------------------------------------------------

    def person_detect(self, images):
        """(C, H, W, 3) uint8 RGB -> (boxes (C, K, 4), scores (C, K),
        valid (C, K)), with the clip program's bf16 preprocessing."""
        x = self._as_input(images)
        with torch.inference_mode():
            xf = prepare_yolo_images(self.det_cfg, x.to(torch.bfloat16) / 255.0)
            return detect_people(self.detector, self.det_cfg, xf,
                                 (x.shape[1], x.shape[2]), self.compute_dtype)

    def person_pose_detect(self, images, boxes, box_valid):
        """Top-down 2D pose on the (C, K, 4) detection boxes of (C, H, W, 3)
        uint8 frames, batched across cameras. Returns (C, K, J, 3)
        keypoints (x, y, score) and the (C, K) mask."""
        x = self._as_input(images)
        boxes = self._as_input(boxes, torch.float32)
        c, k = boxes.shape[:2]
        with torch.inference_mode():
            eboxes, crops = _pose_crops(self.pose_cfg, x.to(torch.bfloat16) / 255.0, boxes)
            kps = decode_heatmaps_auto(self.pose_model(crops, self.compute_dtype).contiguous(),
                                       eboxes, refine=self.pose_cfg.decode_refine)
        return kps.reshape(c, k, self.pose_cfg.num_joints, 3), box_valid

    def process_frame(self, frame_id, images):
        """Detect, pose and track one multi-view frame.

        Args:
          images: (C, H, W, 3) uint8 RGB.
        Returns:
          (FrameOutput, detections (C, D, J, 3), det_mask (C, D)).
        """
        x = self._as_input(images)
        with torch.inference_mode():
            dets, mask = _clip_detections(
                self.det_cfg, self.pose_cfg, self.tracker_cfg, self.detector,
                self.pose_model, x, self.compute_dtype)
            self.state, out = make_step_fn(self.tracker_cfg)(self.cams, self.state, dets,
                                                             mask, frame_id)
        return out, dets, mask

    def person_track(self, frame_id, detections, det_mask) -> FrameOutput:
        """One tracker step on (C, D, J, 3) detections and a (C, D) mask;
        returns the FrameOutput and updates self.state."""
        with torch.inference_mode():
            self.state, out = make_step_fn(self.tracker_cfg)(
                self.cams, self.state, self._as_input(detections, torch.float32),
                self._as_input(det_mask, torch.bool), frame_id)
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

    def process_clips_nn(self, clips):
        """Stage A for a batch of clips: (B, F, C, H, W, 3) uint8 ->
        ((B, F, C, D, J, 3) detections, (B, F, C, D) mask)."""
        outs = [self.process_clip_nn(clip) for clip in self._as_input(clips)]
        return (torch.stack([d for d, _ in outs]), torch.stack([m for _, m in outs]))

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
