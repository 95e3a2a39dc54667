"""End-to-end accuracy machinery: synthetic scene -> model-input crops ->
decoded keypoints -> the tracker -> PCP.

Counterpart of `tpupose/eval/e2e.py`. The reference's accuracy contract is
3D PCP after triangulation (`src/evalmodel.py:120-206`), not 2D keypoint
agreement. This module builds the chain between a 2D pose backbone (bf16 or
int8) and that metric without a dataset: a synthetic multi-camera scene
with known ground truth, crops rendered at the projected keypoints in the
blob-localization style the trained models were fitted on
(`tpupose_torch.models.train.blob_localization_batch`), HRNet and the
heatmap decode (kernel K1 on the card), and the tracker and PCP scorer
downstream.
"""
from __future__ import annotations

import numpy as np
import torch


def render_blob_crop(kps_crop, h, w, blob_sigma=2.5):
    """One (h, w, 3) blob crop, the rendering of `blob_localization_batch`:
    base 0.35, a distinct-colored Gaussian per joint, clipped to [0, 1].
    Local 5-sigma windows (the tail cut is exp(-12.5) ~ 4e-6) keep
    hundreds of renders fast."""
    from tpupose_torch.models.train import JOINT_COLORS

    img = np.full((h, w, 3), 0.35, np.float32)
    r = int(np.ceil(5 * blob_sigma))
    for j in range(kps_crop.shape[0]):
        x, y = float(kps_crop[j, 0]), float(kps_crop[j, 1])
        x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
        y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * blob_sigma**2))
        color = JOINT_COLORS[j % len(JOINT_COLORS)]
        img[y0:y1, x0:x1] += blob[..., None] * (color / 255.0 - 0.35)
    return np.clip(img, 0, 1)


def crop_boxes_for_scene(scene, cfg, margin_px=15.0):
    """Aspect-fitted crop boxes around every (frame, camera, actor)'s
    ground-truth projection. Returns (kps (T*C*A, 17, 2) image px, eboxes
    (T*C*A, 4) f32), index order frame-major, then camera, then actor."""
    from tpupose_torch.ops.heatmap import expand_box_to_aspect

    in_h, in_w = cfg.input_size
    T, C, A = scene.num_frames, scene.num_cameras, scene.num_actors
    kps = scene.gt2d.reshape(T * C * A, 17, 2)
    lo = kps.min(axis=1) - margin_px
    hi = kps.max(axis=1) + margin_px
    boxes = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    eboxes = expand_box_to_aspect(torch.from_numpy(boxes), in_h / in_w).numpy()
    return kps, eboxes


def image_to_crop(kps_img, ebox, in_h, in_w):
    """(J, 2) image-space keypoints in crop pixel coordinates: the inverse
    of the decode's box mapping (`ops.heatmap.decode_heatmaps`)."""
    x0, y0, x1, y1 = ebox
    return np.stack(
        [
            (kps_img[:, 0] - x0) * in_w / (x1 - x0),
            (kps_img[:, 1] - y0) * in_h / (y1 - y0),
        ],
        axis=-1,
    )


def build_scene_crops(cfg, num_frames=40, num_actors=2, margin_px=15.0, seed=0,
                      scene=None):
    """A synthetic scene (or `scene`) and its rendered model-input crops.

    Returns (scene, crops (T*C*A, H, W, 3) f32 in [0, 1], eboxes (T*C*A, 4)
    image-space crop boxes)."""
    from tpupose_torch.data.synthetic import make_scene

    if scene is None:
        scene = make_scene(num_frames=num_frames, num_actors=num_actors, noise_px=0.0,
                           seed=seed)
    in_h, in_w = cfg.input_size
    kps, eboxes = crop_boxes_for_scene(scene, cfg, margin_px=margin_px)
    crops = np.zeros((kps.shape[0], in_h, in_w, 3), np.float32)
    for i in range(kps.shape[0]):
        kc = image_to_crop(kps[i], eboxes[i], in_h, in_w)
        crops[i] = render_blob_crop(kc, in_h, in_w)
    return scene, crops, eboxes


def decode_tree(model, cfg, crops, eboxes, refine, batch=16, device=None):
    """HRNet forward in bf16 and heatmap decode over batches of `batch` crops.

    `crops` (N, H, W, 3) and `eboxes` (N, 4) are numpy arrays; `model` moves
    to `device` (CUDA when None), where the decode is one launch of K1 per
    batch. Returns (N, 17, 3) keypoints in image coordinates, numpy."""
    from tpupose_torch.ops.heatmap import decode_heatmaps_auto
    from tpupose_torch.pipeline.facade import resolve_device

    device = resolve_device(device)
    model = model.to(device)
    outs = []
    with torch.inference_mode():
        for i in range(0, crops.shape[0], batch):
            # raw [0, 1] crops, no ImageNet normalization: the blob-trained
            # models, their BN re-estimation and the int8 calibration all
            # consume the rendered crops as they are, and the decode must
            # see the same distribution (normalizing here scores PCP 0 on
            # every model; real-image serving normalizes in the pipeline)
            x = torch.from_numpy(np.ascontiguousarray(crops[i:i + batch].transpose(0, 3, 1, 2)))
            eb = torch.from_numpy(np.ascontiguousarray(eboxes[i:i + batch], np.float32))
            heat = model(x.to(device), torch.bfloat16)
            outs.append(decode_heatmaps_auto(heat, eb.to(device), refine=refine).cpu())
    return torch.cat(outs).numpy()


def pcp_through_tracker(scene, kps_img, score_scale=10.0, warmup=5, device=None):
    """Decoded keypoints -> the tracker -> per-frame 3D poses -> PCP.

    As the synthetic replay loop of the evaluation CLI: the detections of
    the whole scene go to `device` (CUDA when None) at once, `track_clip`
    runs over them at `TrackerConfig(num_cameras=C)`'s capacities, each
    frame is harvested, and PCP is scored as the reference does
    (`src/evalmodel.py:120-206`) from frame `warmup` on. Heatmap peak
    scores (~10 for the blob-trained models, whose targets are scaled by
    10) map to about [0, 1] through `score_scale`. Returns
    `evaluate_pcp`'s result."""
    from tpupose_torch.eval import coco2shelf3d, evaluate_pcp
    from tpupose_torch.geometry import make_camera_set
    from tpupose_torch.pipeline.facade import Pipeline
    from tpupose_torch.tracking.tracker import FrameOutput, TrackerConfig, track_clip

    T, C, A = scene.num_frames, scene.num_cameras, scene.num_actors
    kps = np.asarray(kps_img, np.float32).reshape(T, C, A, 17, 3).copy()
    kps[..., 2] = np.clip(kps[..., 2] / score_scale, 0.0, 1.0)

    tcfg = TrackerConfig(num_cameras=C)
    rig = make_camera_set(scene.P, scene.K, scene.RT, scene.width, scene.height)
    pipe = Pipeline(rig, tcfg, device=device)
    dets = np.zeros((T, C, tcfg.max_dets, 17, 3), np.float32)
    mask = np.zeros((T, C, tcfg.max_dets), bool)
    dets[:, :, :A] = kps
    mask[:, :, :A] = True

    with torch.inference_mode():
        pipe.state, outs = track_clip(
            tcfg, pipe.cams, pipe.state, torch.from_numpy(dets).to(pipe.device),
            torch.from_numpy(mask).to(pipe.device),
            torch.arange(T, dtype=torch.int32, device=pipe.device))
    outs = FrameOutput(*(x.cpu() for x in outs))
    multi_poses3d = {}
    for t in range(T):
        pts3d, _, _ = pipe.harvest(FrameOutput(*(x[t] for x in outs)), t)
        multi_poses3d[t] = pts3d
    actors_gt = [[coco2shelf3d(scene.gt3d[t, a].T) for t in range(T)] for a in range(A)]
    return evaluate_pcp([[warmup, T]], multi_poses3d, actors_gt, num_report_actors=A)
