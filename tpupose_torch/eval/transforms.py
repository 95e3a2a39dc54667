"""Joint-order converters between skeleton formats.

Counterpart of `tpupose/eval/transforms.py`: exact formula ports of
`src/eval/transformation.py` (the interpolation factors shift PCP, so they
are reproduced verbatim). Pipeline-internal skeletons are COCO-17; Shelf
GT is 14 joints, Panoptic GT uses a 15-joint and a 19-joint layout.
"""
from __future__ import annotations

import numpy as np

#: COCO-17 joint names for documentation.
COCO17_NAMES = [
    "nose", "l_eye", "r_eye", "l_ear", "r_ear", "l_shoulder", "r_shoulder",
    "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hip", "r_hip", "l_knee",
    "r_knee", "l_ankle", "r_ankle",
]

_COCO2SHELF = np.array([16, 14, 12, 11, 13, 15, 10, 8, 6, 5, 7, 9])


def coco2shelf3d(coco_pose):
    """COCO-17 (3, 17) -> Shelf order (14, 3) with synthesized head joints
    (`src/eval/transformation.py:5-39`, head factors [0.78, 0.5, 1.5] /
    [0.3, 0.4, 0.6])."""
    coco_pose = np.asarray(coco_pose, np.float64).T  # (17, 3)
    shelf = np.zeros((14, 3))
    shelf[:12] = coco_pose[_COCO2SHELF]
    mid_shoulder = (shelf[8] + shelf[9]) / 2
    shelf[12] = mid_shoulder
    shelf[13] = shelf[12] + (coco_pose[0] - shelf[12]) * np.array([0.78, 0.5, 1.5])
    shelf[12] = shelf[12] + (coco_pose[0] - shelf[12]) * np.array([0.3, 0.4, 0.6])
    return shelf


def coco2panoptic(coco_pose):
    """COCO-17 (3, 17) -> old-style Panoptic-15 (3, 15)
    (`src/eval/transformation.py:42-59`)."""
    coco_pose = np.asarray(coco_pose, np.float64).T
    pano = np.zeros((15, 3))
    map_array = np.array([5, 7, 9, 11, 13, 15, 6, 8, 10, 12, 14, 16])
    pano[3:] = coco_pose[map_array]
    pano[2] = (coco_pose[11] + coco_pose[12]) / 2
    mid_shoulder = (coco_pose[5] + coco_pose[6]) / 2
    nose = coco_pose[0]
    pano[1] = mid_shoulder + (nose - mid_shoulder) * np.array([0.4, 1.75, 0.4])
    pano[0] = mid_shoulder + (nose - mid_shoulder) * np.array([0.3, 0.5, 0.3])
    return pano.T


def coco17to19(coco17pose):
    """COCO-17 (17, D) -> COCO-19 (19, D)
    (`src/eval/transformation.py:62-81`)."""
    coco17pose = np.asarray(coco17pose, np.float64)
    out = np.zeros((19, coco17pose.shape[1]))
    index_array = np.array([1, 15, 17, 16, 18, 3, 9, 4, 10, 5, 11, 6, 12, 7, 13, 8, 14])
    out[index_array] = coco17pose
    out[0] = (coco17pose[5] + coco17pose[6]) / 2
    out[2] = (coco17pose[11] + coco17pose[12]) / 2
    out[-4:] = coco17pose[0]
    return out


def coco2panoptic14(pose_3x17):
    """COCO-17 (3, 17) -> the 14-joint layout of the Panoptic AP scorer
    (`src/evalmodel.py:310-314`; the caller scales to mm): rows = [nose,
    pelvis, l_shoulder, l_elbow, l_wrist, l_hip, l_knee, l_ankle,
    r_shoulder, r_elbow, r_wrist, r_hip, r_knee, r_ankle]."""
    pose = np.asarray(pose_3x17, np.float64).T  # (17, 3)
    pelvis = (pose[11] + pose[12]) / 2
    sel = pose[[0, 5, 7, 9, 11, 13, 15, 6, 8, 10, 12, 14, 16]]
    return np.insert(sel, 1, pelvis, axis=0)  # (14, 3)


def nan_masked_sqdist(gt, preds):
    """Nearest-pose matching distance (`src/eval/numeric.py:5-25`).

    Args:
      gt: (J, 3) ground-truth pose.
      preds: (M, J, 3) candidate poses.

    Returns:
      (M,) squared distances over the non-NaN coordinates of each pred.
    """
    g = np.asarray(gt, np.float64).reshape(-1)
    out = np.zeros(len(preds))
    for i, p in enumerate(np.asarray(preds, np.float64).reshape(len(preds), -1)):
        keep = ~np.isnan(p)
        diff = g[keep] - p[keep]
        out[i] = np.dot(diff, diff)
    return out
