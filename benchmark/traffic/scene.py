"""Replayed 2D detections: a frozen copy of the port's synthetic scene
generator (`data/synthetic.py` at the commit that added this benchmark),
numpy only: a calibrated camera ring, actors on continuous Lissajous orbits
through the scene centre with a swaying COCO-17 skeleton, and the
adversarial detection fabric (pixel noise, view-dependent occlusion, false
positives, dropouts, shuffled order). The same seed gives the same scene as
the generator it was copied from (`benchmark/tests` holds them equal).
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


def _adversarialize(gt3d, P, K, RT, rng, *, noise_px, drop_prob,
                    enforce_two_views, occlusion_px, fp_per_view, fp_score,
                    shuffle):
    """Shared detection-fabric for adversarial scenes: projections + noise,
    view-dependent occlusion, i.i.d. dropouts, false positives, per-view
    detection-order shuffling."""
    num_frames, num_actors = gt3d.shape[:2]
    C = P.shape[0]
    gt2d = np.zeros((num_frames, C, num_actors, 17, 2))
    for c in range(C):
        gt2d[:, c] = _project(P[c].astype(np.float64), gt3d)

    det_xy = gt2d + rng.normal(scale=noise_px, size=gt2d.shape)
    scores = np.clip(
        rng.normal(0.85, 0.05, size=gt2d.shape[:-1] + (1,)), 0.3, 1.0
    )
    actor_dets = np.concatenate([det_xy, scores], axis=-1)

    visible = rng.uniform(size=(num_frames, C, num_actors)) >= drop_prob
    if enforce_two_views:
        for t in range(num_frames):
            for a in range(num_actors):
                if visible[t, :, a].sum() < 2:
                    visible[t, :2, a] = True

    # View-dependent occlusion: hip midpoint proximity in image space drops
    # the actor farther from the camera.
    cam_pos = np.stack(
        [-(RT[c, :, :3].T @ RT[c, :, 3]) for c in range(C)]
    )  # camera centers
    hips3d = gt3d[:, :, [11, 12]].mean(axis=2)  # (T, A, 3)
    hips2d = gt2d[:, :, :, [11, 12]].mean(axis=3)  # (T, C, A, 2)
    for t in range(num_frames):
        for c in range(C):
            depth = np.linalg.norm(hips3d[t] - cam_pos[c], axis=-1)  # (A,)
            for a in range(num_actors):
                for b in range(a + 1, num_actors):
                    if np.linalg.norm(hips2d[t, c, a] - hips2d[t, c, b]) < occlusion_px:
                        far = a if depth[a] > depth[b] else b
                        visible[t, c, far] = False

    # False positives: real poses displaced into empty space.
    n_fp = int(fp_per_view)
    if n_fp:
        fp = np.zeros((num_frames, C, n_fp, 17, 3))
        fp_vis = np.ones((num_frames, C, n_fp), bool)
        for t in range(num_frames):
            for c in range(C):
                for i in range(n_fp):
                    src = rng.integers(num_actors)
                    offset = rng.uniform(120, 400, size=2) * rng.choice([-1, 1], 2)
                    fp[t, c, i, :, :2] = gt2d[t, c, src] + offset
                    fp[t, c, i, :, 2] = fp_score
        detections = np.concatenate([actor_dets, fp], axis=2)
        visible = np.concatenate([visible, fp_vis], axis=2)
    else:
        detections = actor_dets

    if shuffle:
        for t in range(num_frames):
            for c in range(C):
                perm = rng.permutation(detections.shape[2])
                detections[t, c] = detections[t, c, perm]
                visible[t, c] = visible[t, c, perm]

    return SyntheticScene(
        P=P, K=K, RT=RT, gt3d=gt3d, gt2d=gt2d,
        detections=detections.astype(np.float32), visible=visible,
    )


def make_continuous_adversarial_scene(
    num_frames=1000,
    num_cameras=5,
    num_actors=3,
    noise_px=1.5,
    seed=0,
    occlusion_px=60.0,
    fp_per_view=0,
    fp_score=0.75,
    drop_prob=0.0,
    shuffle=True,
) -> SyntheticScene:
    """Arbitrarily long CONTINUOUS adversarial stream (no teleports).

    `make_adversarial_scene` walks straight lines across the scene once —
    looping it repeats the clip verbatim, so every wrap teleports the
    actors and forces delete/re-init churn that a steady-state deployment
    never sees. Here actors follow incommensurate
    Lissajous orbits inside the rig: smooth bounded motion at walking
    speed that repeatedly funnels everyone through the scene center
    (recurring image-space crossings in every view), forever. The same
    occlusion / false-positive / shuffle fabric as the adversarial scene
    applies per frame.
    """
    rng = np.random.default_rng(seed)
    P, K, RT = camera_ring(num_cameras=num_cameras)

    # Per-actor Lissajous parameters: irrational-ish frequency ratios so
    # the orbit never exactly repeats; ~0.05 rad/frame => ~0.1 m/frame at
    # the 2 m amplitude, a walking pace at 25 Hz.
    wx = 0.045 + 0.01 * rng.uniform(size=num_actors)
    wy = wx * (np.sqrt(2.0) / 2.0 + 0.1 * rng.uniform(size=num_actors))
    px = rng.uniform(0, 2 * np.pi, size=num_actors)
    py = rng.uniform(0, 2 * np.pi, size=num_actors)
    sway_phase = rng.uniform(0, 2 * np.pi, size=num_actors)

    t_arr = np.arange(num_frames)
    cx = 2.0 * np.cos(wx[None, :] * t_arr[:, None] + px[None, :])  # (T, A)
    cy = 2.0 * np.sin(wy[None, :] * t_arr[:, None] + py[None, :])
    # heading from the velocity of the orbit (continuous by construction)
    vx = np.gradient(cx, axis=0)
    vy = np.gradient(cy, axis=0)
    heading = np.arctan2(vy, vx)

    gt3d = np.zeros((num_frames, num_actors, 17, 3))
    for t in range(num_frames):
        for a in range(num_actors):
            pose = COCO17_REST.copy()
            s = np.sin(0.4 * t + sway_phase[a])
            pose[[7, 9], 1] += 0.05 * s
            pose[[8, 10], 1] -= 0.05 * s
            h = heading[t, a]
            rot = np.array(
                [[np.cos(h), -np.sin(h), 0],
                 [np.sin(h), np.cos(h), 0], [0, 0, 1]]
            )
            pose = pose @ rot.T
            pose[:, 0] += cx[t, a]
            pose[:, 1] += cy[t, a]
            gt3d[t, a] = pose

    return _adversarialize(
        gt3d, P, K, RT, rng, noise_px=noise_px, drop_prob=drop_prob,
        enforce_two_views=False, occlusion_px=occlusion_px,
        fp_per_view=fp_per_view, fp_score=fp_score, shuffle=shuffle,
    )
