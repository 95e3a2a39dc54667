"""Limb length sanity tables and checks (numpy).

Counterpart of `tpupose/utils/limbs.py`: a port of `src/utils/default_limbs.py`
and `correct_limbs` (`src/utils/construction.py:133-186`). The reference
never calls `correct_limbs` on its main path; here it is an optional
post-triangulation filter that masks joints instead of setting them to None.
"""
from __future__ import annotations

import numpy as np

#: Joint naming used by the limb tables (the reference's 18-joint layout).
JOINT_NAMES = [
    "Nose", "Neck", "Shoulder right", "Elbow right", "Hand right",
    "Shoulder left", "Elbow left", "Hand left", "Hip right", "Knee right",
    "Foot right", "Hip left", "Knee left", "Foot left", "Eye right",
    "Eye left", "Ear right", "Ear left",
]

JOINT_TO_GT_JOINT = np.array(
    [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 0, 0, 0, 0]
)

SYMMETRIC_JOINTS = np.array(
    [(2, 5), (3, 6), (4, 7), (8, 11), (9, 12), (10, 13), (14, 15), (16, 17)]
)

#: (lower, upper) plausible limb lengths in metres
#: (`src/utils/default_limbs.py:59-92`).
SENSIBLE_LIMB_LENGTH = np.array(
    [
        (0.05, 0.4),   # head - neck
        (0.03, 0.4),   # neck - left shoulder
        (0.03, 0.4),   # neck - right shoulder
        (0.05, 0.5),   # left shoulder - left elbow
        (0.05, 0.5),   # left elbow - left wrist
        (0.05, 0.5),   # right shoulder - right elbow
        (0.05, 0.5),   # right elbow - right wrist
        (0.3, 0.75),   # neck - pelvis
        (0.03, 0.4),   # pelvis - left hip
        (0.03, 0.4),   # pelvis - right hip
        (0.2, 0.6),    # left hip - left knee
        (0.2, 0.6),    # left knee - left ankle
        (0.2, 0.6),    # right hip - right knee
        (0.2, 0.6),    # right knee - right ankle
    ]
)


def limb_length_ok(a, b, limb_index, scale_to_m=1.0):
    """True if |a-b| * scale is inside the plausible range for limb_index."""
    lo, hi = SENSIBLE_LIMB_LENGTH[limb_index]
    d = np.linalg.norm(np.asarray(a) - np.asarray(b)) * scale_to_m
    return lo <= d <= hi


#: correct_limbs' checks on the reference's 14/18-joint skeleton
#: (`construction.py:133-166`): (parent, child, limb_row, also_invalidate).
_CORRECT_CHECKS = [
    (5, 6, 2, (6, 7)),   # left upper arm bad -> drop elbow+hand
    (6, 7, 3, (7,)),     # left lower arm bad -> drop hand
    (2, 3, 2, (3, 4)),   # right upper arm
    (3, 4, 3, (4,)),     # right lower arm
    (11, 12, 7, (12, 13)),  # left upper leg (reference uses rows 7/8)
    (12, 13, 8, (13,)),     # left lower leg
    (8, 9, 7, (9, 10)),     # right upper leg
    (9, 10, 8, (10,)),      # right lower leg
]


def correct_limbs_mask(pose, scale_to_m=1.0):
    """Per-joint validity mask after limb-length sanity checks.

    Mirrors `correct_limbs`'s cascade (a bad upper limb also invalidates
    the extremity; `src/utils/construction.py:141-166`) but returns a
    boolean mask instead of mutating with None.
    """
    pose = np.asarray(pose, np.float64)
    ok = np.ones(len(pose), bool)
    handled = set()
    for a, b, limb, drops in _CORRECT_CHECKS:
        if a in handled:  # upper limb already failed; skip lower check
            continue
        if not limb_length_ok(pose[a], pose[b], limb, scale_to_m):
            for d in drops:
                ok[d] = False
            if len(drops) > 1:
                handled.add(b)
    return ok


# COCO-17 bone list for convenience (pairs of joint indices + limb class).
COCO_BONES = np.array(
    [
        (5, 7), (7, 9),    # left arm
        (6, 8), (8, 10),   # right arm
        (11, 13), (13, 15),  # left leg
        (12, 14), (14, 16),  # right leg
        (5, 6), (11, 12),  # shoulders, hips
    ]
)


def coco_bone_lengths(pose17):
    """Bone lengths of a COCO-17 pose, (10,)."""
    p = np.asarray(pose17)
    return np.linalg.norm(p[COCO_BONES[:, 0]] - p[COCO_BONES[:, 1]], axis=-1)
