"""Epipolar distances, vectorized over (views, views, joints).

Counterpart of `tpupose/geometry/epipolar.py`. Every function also takes
leading batch dimensions on the points (the JAX package vmaps instead).
"""
from __future__ import annotations

import torch


def _homogenize(points_xy):
    ones = torch.ones(points_xy.shape[:-1] + (1,), dtype=points_xy.dtype,
                      device=points_xy.device)
    return torch.cat([points_xy[..., :2], ones], dim=-1)


def point_line_distance_2d(points_xy, lines):
    """Distance from 2D points to lines (a, b, c), ax + by + c = 0; a
    zero-norm line counts as norm 1 (the reference's guard)."""
    pts = _homogenize(points_xy)
    norm = torch.sqrt(torch.sum(lines[..., :2] ** 2, dim=-1))
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return torch.abs(torch.sum(pts * lines, dim=-1)) / norm


def epipolar_distance_directed(F_ab, points_a, points_b):
    """(J,) distances of points_b to the epilines F_ab^T x_a."""
    lines_in_b = _homogenize(points_a[..., :2]) @ F_ab
    return point_line_distance_2d(points_b[..., :2], lines_in_b)


def epipolar_distance_matrix(F_pairs, poses, valid=None):
    """Symmetrized per-joint epipolar distances over all view pairs.

    Args:
      F_pairs: (V, V, 3, 3) with x_a^T F[a, b] x_b = 0.
      poses:   (..., V, J, 2+) 2D poses (x, y[, score]).
      valid:   optional (..., V) mask; pairs touching an invalid view get 0.

    Returns:
      dist (..., V, V, J) and its mean over joints (..., V, V).
    """
    pts = _homogenize(poses[..., :2])  # (..., V, J, 3)
    # lines[a, b, j, i] = sum_k F[a, b][k, i] * x_a[j, k]
    lines = torch.einsum("abki,...ajk->...abji", F_pairs, pts)
    d_directed = point_line_distance_2d(poses[..., None, :, :, :2], lines)
    dist = 0.5 * (d_directed + d_directed.transpose(-3, -2))
    if valid is not None:
        pair_ok = valid[..., :, None] & valid[..., None, :]
        dist = torch.where(pair_ok[..., None], dist, torch.zeros_like(dist))
    return dist, dist.mean(dim=-1)
