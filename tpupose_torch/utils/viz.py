"""2D skeleton overlay drawing (numpy, no cv2 dependency).

Counterpart of `tpupose/utils/viz.py`, pixel for pixel; replaces the
reference's use of the HRPose repo's `draw_points_and_skeleton`
(`src/testmodel.py:34,74-76`).
"""
from __future__ import annotations

import numpy as np

#: COCO-17 skeleton edges (joint index pairs).
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]

_PALETTE = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 190],
    ],
    np.uint8,
)


def _draw_line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _draw_point(img, x, y, color, r=2):
    h, w = img.shape[:2]
    y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
    x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
    img[y0:y1, x0:x1] = color


def draw_skeleton_overlay(image, pose_xy, scores, person_id,
                          confidence_threshold=0.0):
    """Draw one person's 2D skeleton. pose_xy: (J, 2) (x, y)."""
    img = np.ascontiguousarray(image)
    color = _PALETTE[int(person_id) % len(_PALETTE)]
    for a, b in COCO_SKELETON:
        if scores[a] > confidence_threshold and scores[b] > confidence_threshold:
            _draw_line(img, pose_xy[a, 0], pose_xy[a, 1],
                       pose_xy[b, 0], pose_xy[b, 1], color)
    for j in range(len(pose_xy)):
        if scores[j] > confidence_threshold:
            _draw_point(img, pose_xy[j, 0], pose_xy[j, 1], color)
    return img
