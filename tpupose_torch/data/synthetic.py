"""Synthetic multi-camera scene generator (numpy only).

The port's own copy of `make_scene` and its helpers from
`tpupose/data/synthetic.py`: a calibrated camera ring and actors walking
smooth paths with a swaying COCO-17 skeleton, giving ground-truth 3D poses,
per-view projections and noisy detections. The same seed gives the same
scene as the JAX package's generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# A neutral standing COCO-17 skeleton (x, y, z) in meters, z up, origin at
# ground below the pelvis. Order: nose, l/r eye, l/r ear, l/r shoulder,
# l/r elbow, l/r wrist, l/r hip, l/r knee, l/r ankle.
COCO17_REST = np.array(
    [
        [0.00, 0.00, 1.70],  # nose
        [0.03, 0.03, 1.73],  # l eye
        [-0.03, 0.03, 1.73],  # r eye
        [0.07, 0.00, 1.71],  # l ear
        [-0.07, 0.00, 1.71],  # r ear
        [0.18, 0.00, 1.50],  # l shoulder
        [-0.18, 0.00, 1.50],  # r shoulder
        [0.25, 0.03, 1.25],  # l elbow
        [-0.25, 0.03, 1.25],  # r elbow
        [0.28, 0.06, 1.00],  # l wrist
        [-0.28, 0.06, 1.00],  # r wrist
        [0.10, 0.00, 0.95],  # l hip
        [-0.10, 0.00, 0.95],  # r hip
        [0.12, 0.02, 0.50],  # l knee
        [-0.12, 0.02, 0.50],  # r knee
        [0.13, 0.00, 0.05],  # l ankle
        [-0.13, 0.00, 0.05],  # r ankle
    ],
    np.float64,
)


def look_at_rt(eye, target, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return np.concatenate([R, (-R @ eye)[:, None]], axis=1)


def camera_ring(num_cameras=5, radius=7.0, height=2.5, f=900.0, w=1280, h=720):
    """(P, K, RT) for a ring of cameras looking at the scene center."""
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    Ps, Ks, RTs = [], [], []
    for i in range(num_cameras):
        ang = 2 * np.pi * i / num_cameras + 0.23
        eye = (radius * np.cos(ang), radius * np.sin(ang), height + 0.2 * (i % 3))
        RT = look_at_rt(eye, (0.0, 0.0, 1.0))
        Ps.append(K @ RT)
        Ks.append(K)
        RTs.append(RT)
    return (
        np.stack(Ps).astype(np.float32),
        np.stack(Ks).astype(np.float32),
        np.stack(RTs).astype(np.float32),
    )


@dataclasses.dataclass
class SyntheticScene:
    """Ground truth + detections for a multi-camera clip.

    Attributes:
      P, K, RT: camera calibration stacks.
      gt3d: (T, A, J, 3) ground-truth 3D poses (meters).
      gt2d: (T, C, A, J, 2) exact projections.
      detections: (T, C, A, J, 3) noisy (x, y, score); actors may be dropped
                  per (frame, camera) via `visible`.
      visible: (T, C, A) bool detection visibility.
      width, height: image size.
    """

    P: np.ndarray
    K: np.ndarray
    RT: np.ndarray
    gt3d: np.ndarray
    gt2d: np.ndarray
    detections: np.ndarray
    visible: np.ndarray
    width: int = 1280
    height: int = 720

    @property
    def num_frames(self):
        return self.gt3d.shape[0]

    @property
    def num_cameras(self):
        return self.P.shape[0]

    @property
    def num_actors(self):
        return self.gt3d.shape[1]

    def detections_list(self, t):
        """Per-camera list of (M, J, 3) visible detections at frame t."""
        out = []
        for c in range(self.num_cameras):
            vis = self.visible[t, c]
            out.append(self.detections[t, c][vis])
        return out


def _project(P, pts3d):
    hom = np.concatenate([pts3d, np.ones_like(pts3d[..., :1])], axis=-1)
    proj = np.einsum("ij,...j->...i", P, hom)
    return proj[..., :2] / proj[..., 2:3]


def make_scene(
    num_frames=60,
    num_cameras=5,
    num_actors=3,
    noise_px=1.0,
    drop_prob=0.0,
    seed=0,
    walk_speed=0.04,
    sway=0.05,
) -> SyntheticScene:
    """Build a deterministic synthetic scene.

    Actors walk smooth circular-ish paths inside a 4x4 m area, limbs sway
    sinusoidally; detections get isotropic Gaussian pixel noise and
    per-(frame, camera, actor) dropouts.
    """
    rng = np.random.default_rng(seed)
    P, K, RT = camera_ring(num_cameras=num_cameras)
    C = num_cameras

    centers0 = rng.uniform(-1.5, 1.5, size=(num_actors, 2))
    headings = rng.uniform(0, 2 * np.pi, size=num_actors)
    phase = rng.uniform(0, 2 * np.pi, size=num_actors)

    gt3d = np.zeros((num_frames, num_actors, 17, 3))
    for t in range(num_frames):
        for a in range(num_actors):
            ang = headings[a] + 0.02 * t
            cx = centers0[a, 0] + walk_speed * t * np.cos(ang)
            cy = centers0[a, 1] + walk_speed * t * np.sin(ang)
            # keep actors inside the rig
            cx = 2.0 * np.tanh(cx / 2.0)
            cy = 2.0 * np.tanh(cy / 2.0)
            pose = COCO17_REST.copy()
            s = np.sin(0.4 * t + phase[a])
            # arm/leg sway so joints move relative to each other
            pose[[7, 9], 1] += sway * s
            pose[[8, 10], 1] -= sway * s
            pose[[13, 15], 0] += sway * 0.5 * s
            pose[[14, 16], 0] -= sway * 0.5 * s
            rot = np.array(
                [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
            )
            pose = pose @ rot.T
            pose[:, 0] += cx
            pose[:, 1] += cy
            gt3d[t, a] = pose

    gt2d = np.zeros((num_frames, C, num_actors, 17, 2))
    for c in range(C):
        gt2d[:, c] = _project(P[c].astype(np.float64), gt3d)

    noise = rng.normal(scale=noise_px, size=gt2d.shape)
    det_xy = gt2d + noise
    scores = np.clip(rng.normal(0.85, 0.05, size=gt2d.shape[:-1] + (1,)), 0.3, 1.0)
    detections = np.concatenate([det_xy, scores], axis=-1).astype(np.float32)
    visible = rng.uniform(size=(num_frames, C, num_actors)) >= drop_prob
    # Always keep at least 2 views per actor per frame so GT remains buildable.
    for t in range(num_frames):
        for a in range(num_actors):
            if visible[t, :, a].sum() < 2:
                visible[t, :2, a] = True

    return SyntheticScene(
        P=P, K=K, RT=RT, gt3d=gt3d, gt2d=gt2d,
        detections=detections, visible=visible,
    )

