"""Cached-2D-detections replay: re-score without the networks.

Counterpart of `tpupose/data/replay.py`. The reference's pose backend
emits, per camera, a list of dicts {'bbox': [x, y, w, h], 'keypoints':
flat (J*3) rows of (y, x, _), 'keypoints_score': (J,), 'feature': [...]}
(simple-HRNet's dump format), which `PersonTrack_Project3DPose` unpacks and
column-swaps at `src/ivclabpose.py:216-254`. A replay dump is a pickle
mapping frame key -> that per-camera structure; this module converts it
into padded (C, D, J, 3) (x, y, score) detection arrays so the tracker can
be re-driven exactly as if the backends had just run.
"""
from __future__ import annotations

import pickle

import numpy as np


def save_detection_dump(path, dump):
    """dump: {frame_key: [per-camera list of detection dicts]}."""
    with open(path, "wb") as f:
        pickle.dump(dump, f)


def load_detection_dump(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_frame_to_dets(per_camera, num_cameras, max_dets, num_joints=17):
    """One frame's reference-format dump -> padded detection arrays.

    Mirrors the reference ingest (`src/ivclabpose.py:233-246`): keypoints
    reshape to (J, 3) whose first two columns arrive in simple-HRNet's
    (y, x) order, the third column is OVERWRITTEN by `keypoints_score`, and
    the output is stored (x, y, score).

    Returns:
      dets: (C, D, J, 3) float32 (x, y, score); mask: (C, D) bool.
    """
    dets = np.zeros((num_cameras, max_dets, num_joints, 3), np.float32)
    mask = np.zeros((num_cameras, max_dets), bool)
    for c, items in enumerate(per_camera[:num_cameras]):
        for d, item in enumerate(items[:max_dets]):
            kp = np.asarray(item["keypoints"], np.float32).reshape(num_joints, 3)
            score = np.asarray(item["keypoints_score"], np.float32).reshape(-1)
            dets[c, d, :, 0] = kp[:, 1]  # x
            dets[c, d, :, 1] = kp[:, 0]  # y
            dets[c, d, :, 2] = score
            mask[c, d] = True
    return dets, mask


def dets_to_dump_frame(dets, mask):
    """Inverse of `dump_frame_to_dets`: detections in the reference dump
    convention (to export the port's own backend outputs in a re-scorable
    form, and to build replay fixtures)."""
    per_camera = []
    for c in range(dets.shape[0]):
        items = []
        for d in range(dets.shape[1]):
            if not mask[c, d]:
                continue
            kp = np.zeros((dets.shape[2], 3), np.float32)
            kp[:, 0] = dets[c, d, :, 1]  # y
            kp[:, 1] = dets[c, d, :, 0]  # x
            kp[:, 2] = dets[c, d, :, 2]
            x = dets[c, d, :, 0]
            y = dets[c, d, :, 1]
            items.append(
                {
                    "bbox": [
                        float(x.min()), float(y.min()),
                        float(x.max() - x.min()), float(y.max() - y.min()),
                    ],
                    "keypoints": kp.ravel().tolist(),
                    "keypoints_score": dets[c, d, :, 2].tolist(),
                    "feature": [],
                }
            )
        per_camera.append(items)
    return per_camera


def replay_frame_source(cfg, dump, max_dets, num_joints=17):
    """Frame source driving `run_eval_loop` from a detection dump.

    Yields (frame_id, timestamp, None, dets, mask) over the config's
    TEST_RANGE. Frame keys are looked up as frame ids (falling back to the
    per-frame timestamp for Panoptic-style dumps).
    """
    from tpupose_torch.data.dataset import load_filenames, parse_timestamp

    num_cameras = len(cfg.dataset.folders_order)
    try:
        datas = load_filenames(cfg.dataset)
    except OSError:
        datas = []
    start, end = cfg.dataset.test_range
    for frame_id in range(start, end):
        if datas and frame_id < len(datas):
            timestamp = parse_timestamp(
                cfg.dataset.test_dataset, datas[frame_id][0]
            )
        else:
            timestamp = frame_id
        per_camera = dump.get(frame_id, dump.get(timestamp))
        if per_camera is None:
            per_camera = [[] for _ in range(num_cameras)]
        dets, mask = dump_frame_to_dets(
            per_camera, num_cameras, max_dets, num_joints
        )
        yield frame_id, timestamp, None, dets, mask
