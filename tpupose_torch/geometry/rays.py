"""Back-projection rays and 3D line distances (counterpart of
`tpupose/geometry/rays.py`), points in (x, y)."""
from __future__ import annotations

import torch


def back_project_rays(rk_inv, points_xy):
    """Unit world-space ray directions through (..., N, 2) pixels for
    (..., 3, 3) R^-1 K^-1 matrices (broadcast like a matmul)."""
    ones = torch.ones(points_xy.shape[:-1] + (1,), dtype=points_xy.dtype,
                      device=points_xy.device)
    hom = torch.cat([points_xy[..., :2], ones], dim=-1)
    d = hom @ rk_inv.transpose(-1, -2)
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return d / norm


def line_point_distance_3d(origin, directions, points3d):
    """Distance from 3D points to the lines origin + t * direction."""
    cross = torch.linalg.cross(*torch.broadcast_tensors(
        directions, origin - points3d))
    dn = torch.linalg.vector_norm(directions, dim=-1)
    dn = torch.where(dn == 0.0, torch.ones_like(dn), dn)
    return torch.linalg.vector_norm(cross, dim=-1) / dn


def line_line_distance_3d(p1, d1, p2, d2):
    """Distance between two 3D lines."""
    n = torch.linalg.cross(*torch.broadcast_tensors(d1, d2))
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return torch.abs(torch.sum(n / norm * (p1 - p2), dim=-1))
