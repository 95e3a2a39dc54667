"""Camera model as a NamedTuple of stacked tensors.

Counterpart of `tpupose/geometry/cameras.py`: per-camera projection
matrices P (3x4), intrinsics K, extrinsics RT, the precomputed R^-1 K^-1 and
camera centres, and all-pairs fundamental matrices with the +1e-12 nudge for
all-zero results. 2D points are (x, y) everywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraSet(NamedTuple):
    """Calibrated multi-camera rig.

    Attributes:
      P:      (C, 3, 4) projection matrices (K @ RT).
      K:      (C, 3, 3) intrinsics.
      RT:     (C, 3, 4) extrinsics [R | t] mapping world -> camera.
      F:      (C, C, 3, 3) fundamental matrices; x_a^T F[a, b] x_b = 0.
      rk_inv: (C, 3, 3) R^-1 K^-1, pixel -> world-ray matrix.
      center: (C, 3) camera centres in world coordinates.
      size:   (C, 2) image (width, height) per camera.
    """

    P: torch.Tensor
    K: torch.Tensor
    RT: torch.Tensor
    F: torch.Tensor
    rk_inv: torch.Tensor
    center: torch.Tensor
    size: torch.Tensor

    @property
    def num_cameras(self) -> int:
        return self.P.shape[0]

    def to(self, device) -> "CameraSet":
        return CameraSet(*(t.to(device) for t in self))

    # The reference Camera's undistortion hooks are no-ops (its datasets
    # ship undistorted images, `src/ivclabpose.py:48-60`); kept for API
    # parity, where a distortion model would go.
    def undistort(self, images):
        """(..., H, W, C) images -> unchanged (reference parity no-op)."""
        return images

    def undistort_points(self, points2d):
        """(..., 2+) pixel points -> unchanged (reference parity no-op)."""
        return points2d


def _as_f32(x, device=None):
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                           else x, dtype=torch.float32, device=device)


def fundamental_from_krt(K0, R0, T0, K1, R1, T1):
    """Fundamental matrix between two calibrated views:
    F = K0^-T (R0 R1^T) K1^T [K1 R1 R0^T (T0 - R0 R1^T T1)]_x."""
    R_rel = R0 @ R1.T
    t = (K1 @ (R1 @ (R0.T @ (T0 - R_rel @ T1)[:, None])))[:, 0]
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    skew = torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])
    return ((torch.linalg.inv(K0).T @ R_rel) @ K1.T) @ skew


def fundamental_matrices(K, RT):
    """All-pairs fundamental matrices, (C, C, 3, 3). A camera with itself
    gives all zeros, nudged by +1e-12 as the reference does."""
    K = _as_f32(K)
    RT = _as_f32(RT, K.device)
    C = K.shape[0]
    rows = []
    for a in range(C):
        cols = []
        for b in range(C):
            F = fundamental_from_krt(
                K[a], RT[a, :, :3], RT[a, :, 3], K[b], RT[b, :, :3], RT[b, :, 3]
            )
            if float(F.abs().sum()) == 0.0:
                F = F + 1e-12
            cols.append(F)
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def make_camera_set(P, K, RT, width: int, height: int,
                    device=None) -> CameraSet:
    """Build a CameraSet from stacked (C, 3, 4) P, (C, 3, 3) K, (C, 3, 4) RT
    (numpy arrays or tensors), image size shared by all cameras."""
    P = _as_f32(P, device)
    K = _as_f32(K, P.device)
    RT = _as_f32(RT, P.device)
    C = P.shape[0]
    R = RT[:, :, :3]
    t = RT[:, :, 3]
    R_inv = torch.linalg.inv(R)
    rk_inv = R_inv @ torch.linalg.inv(K)
    center = -torch.einsum("cij,cj->ci", R_inv, t)
    F = fundamental_matrices(K, RT)
    size = torch.tensor([[width, height]], dtype=torch.float32,
                        device=P.device).repeat(C, 1)
    return CameraSet(P=P, K=K, RT=RT, F=F, rk_inv=rk_inv, center=center,
                     size=size)


def project_points(P, points3d):
    """Project (..., N, 3) world points through (..., 3, 4) P to (..., N, 2)
    pixels (x, y); z == 0 is guarded with 1e-5 as in the reference."""
    ones = torch.ones(points3d.shape[:-1] + (1,), dtype=points3d.dtype,
                      device=points3d.device)
    hom = torch.cat([points3d, ones], dim=-1)
    proj = hom @ P.transpose(-1, -2)
    z = proj[..., 2:3]
    z = torch.where(z == 0.0, torch.full_like(z, 1e-5), z)
    return proj[..., :2] / z


def load_calibration_pickle(path: str, num_cameras: int | None = None):
    """The reference's `camera_parameter.pickle`: a dict with 'P' (C, 3, 4),
    'K' (C, 3, 3) and 'RT' (C, 3, 4) (`src/ivclabpose.py:162-165`), as
    f32 numpy arrays (P, K, RT), the first `num_cameras` if given. The
    file is unpickled: load only calibration files you trust."""
    import pickle

    with open(path, "rb") as f:
        params = pickle.load(f)
    P = np.asarray(params["P"], np.float32)
    K = np.asarray(params["K"], np.float32)
    RT = np.asarray(params["RT"], np.float32)
    if num_cameras is not None:
        P, K, RT = P[:num_cameras], K[:num_cameras], RT[:num_cameras]
    return P, K, RT
