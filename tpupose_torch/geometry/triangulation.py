"""Time-weighted DLT triangulation with per-joint view masks.

Counterpart of `tpupose/geometry/triangulation.py`, in f32: each (view,
joint) contributes two normalized DLT rows weighted by exp(-lambda_t * T_v);
per joint the 3D point is the smallest eigenvector of the 4x4 normal matrix,
found by adjugate-matvec inverse iteration. Functions take leading batch
dimensions where the JAX package vmaps.
"""
from __future__ import annotations

import torch

#: Relative floor on the per-view time weights inside `triangulate_joints`:
#: each kept view weighs at least 1e-2 x the largest kept weight of its
#: joint, so a stale view stays above f32 rounding in the normal matrix
#: (same constant and reasoning as the JAX package).
TIME_WEIGHT_REL_FLOOR = 1e-2


def dlt_design_rows(P, poses_xy, weights):
    """(V, 3, 4) P, (..., V, J, 2) points, (..., V) weights ->
    (..., V, J, 2, 4) normalized, weighted DLT rows."""
    x = poses_xy[..., 0]
    y = poses_xy[..., 1]
    r0 = x[..., None] * P[:, None, 2, :] - P[:, None, 0, :]
    r1 = y[..., None] * P[:, None, 2, :] - P[:, None, 1, :]
    rows = torch.stack([r0, r1], dim=-2)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return rows / norm * weights[..., :, None, None, None]


def adj4x4(m):
    """Closed-form adjugate and determinant of batched (..., 4, 4)."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    e, f, g, h = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]
    i, j, k, l = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3]
    mm, n, o, p = m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3]

    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm

    c00 = f * kp_lo - g * jp_ln + h * jo_kn
    c01 = -(e * kp_lo - g * ip_lm + h * io_km)
    c02 = e * jp_ln - f * ip_lm + h * in_jm
    c03 = -(e * jo_kn - f * io_km + g * in_jm)

    det = a * c00 + b * c01 + c * c02 + d * c03

    c10 = -(b * kp_lo - c * jp_ln + d * jo_kn)
    c11 = a * kp_lo - c * ip_lm + d * io_km
    c12 = -(a * jp_ln - b * ip_lm + d * in_jm)
    c13 = a * jo_kn - b * io_km + c * in_jm

    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm

    c20 = b * gp_ho - c * fp_hn + d * fo_gn
    c21 = -(a * gp_ho - c * ep_hm + d * eo_gm)
    c22 = a * fp_hn - b * ep_hm + d * en_fm
    c23 = -(a * fo_gn - b * eo_gm + c * en_fm)

    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    c30 = -(b * gl_hk - c * fl_hj + d * fk_gj)
    c31 = a * gl_hk - c * el_hi + d * ek_gi
    c32 = -(a * fl_hj - b * el_hi + d * ej_fi)
    c33 = a * fk_gj - b * ek_gi + c * ej_fi

    adj = torch.stack(
        [
            torch.stack([c00, c10, c20, c30], dim=-1),
            torch.stack([c01, c11, c21, c31], dim=-1),
            torch.stack([c02, c12, c22, c32], dim=-1),
            torch.stack([c03, c13, c23, c33], dim=-1),
        ],
        dim=-2,
    )
    return adj, det


def inv4x4(m):
    """Closed-form cofactor inverse of batched (..., 4, 4)."""
    adj, det = adj4x4(m)
    det = torch.where(det == 0.0, torch.full_like(det, 1e-30), det)
    return adj / det[..., None, None]


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-30)


def _smallest_eigvec_4x4(M, iters: int = 3):
    """Smallest-eigenvalue eigenvector of batched symmetric PSD (..., 4, 4):
    unit-trace scaling, 1e-7 regularization, start from the adjugate's
    largest column, then `iters` adjugate matvecs."""
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] + M[..., 3, 3]
    scale = torch.where(tr > 0, tr, torch.ones_like(tr))[..., None, None]
    Mn = M / scale + 1e-7 * torch.eye(4, dtype=M.dtype, device=M.device)
    adj, _ = adj4x4(Mn)
    col_norm2 = torch.sum(adj * adj, dim=-2)
    best = torch.argmax(col_norm2, dim=-1)
    v = torch.take_along_dim(adj, best[..., None, None], dim=-1)[..., 0]
    small = torch.linalg.vector_norm(v, dim=-1, keepdim=True) < 1e-30
    v = v + small.to(v.dtype)
    for _ in range(iters):
        v = _unit(v)
        v = (adj @ v[..., None])[..., 0]
    return _unit(v)


def _dehomogenize(X):
    w = X[..., 3:4]
    tiny = torch.where(w < 0, torch.full_like(w, -1e-12), torch.full_like(w, 1e-12))
    w = torch.where(torch.abs(w) < 1e-12, tiny, w)
    return X[..., :3] / w


def triangulate_joints(P, poses_xy, view_weights, keep_mask, fallback=None,
                       min_views: int = 2):
    """Triangulate J joints from V views with per-joint view masks.

    Args:
      P: (V, 3, 4) projection matrices.
      poses_xy: (..., V, J, 2) 2D joints (x, y).
      view_weights: (..., V) time weights exp(-lambda_t * T_v).
      keep_mask: (..., V, J) bool, view v participates in joint j.
      fallback: optional (..., J, 3) pose for joints with < min_views views.

    Returns:
      pose3d (..., J, 3) and n_views (..., J) int32.
    """
    rows = dlt_design_rows(P, poses_xy[..., :2], torch.ones_like(view_weights))
    w = view_weights[..., :, None] * keep_mask
    wmax = torch.amax(w, dim=-2, keepdim=True)
    w = torch.maximum(w, wmax * TIME_WEIGHT_REL_FLOOR) * keep_mask
    rows = rows * w[..., None, None]
    M = torch.einsum("...vjra,...vjrb->...jab", rows, rows)
    pts = _dehomogenize(_smallest_eigvec_4x4(M))
    n_views = keep_mask.sum(dim=-2).to(torch.int32)
    if fallback is not None:
        pts = torch.where((n_views >= min_views)[..., None], pts, fallback)
    return pts, n_views


def triangulate_pairwise(P_a, P_b, pts_a, pts_b):
    """Two-view homogeneous DLT (cv2.triangulatePoints semantics):
    (3, 4) P_a, P_b and (J, 2) points -> (J, 3)."""
    def rows_for(P, pts):
        r0 = pts[:, 0:1] * P[2][None, :] - P[0][None, :]
        r1 = pts[:, 1:2] * P[2][None, :] - P[1][None, :]
        return torch.stack([r0, r1], dim=1)

    A = torch.cat([rows_for(P_a, pts_a), rows_for(P_b, pts_b)], dim=1)
    M = torch.einsum("jra,jrb->jab", A, A)
    return _dehomogenize(_smallest_eigvec_4x4(M))


def triangulate_top_down(P, poses_xy, weights2d, view_valid=None):
    """All-pairs two-view DLT; keep the pair with the least total
    reprojection error. Returns ((J, 3) pose, (J,) mean pair weight)."""
    V = P.shape[0]
    if view_valid is None:
        view_valid = torch.ones(V, dtype=torch.bool, device=P.device)
    poses, errs, weights, pair_ok = [], [], [], []
    for a in range(V):
        for b in range(a + 1, V):
            pose = triangulate_pairwise(P[a], P[b], poses_xy[a], poses_xy[b])
            hom = torch.cat([pose, torch.ones_like(pose[..., :1])], dim=-1)
            proj = torch.einsum("vik,jk->vji", P, hom)
            xy = proj[..., :2] / (proj[..., 2:3] + 1e-5)
            per_view = torch.sqrt(torch.sum((xy - poses_xy) ** 2, dim=(1, 2)))
            errs.append(torch.sum(torch.where(view_valid, per_view,
                                              torch.zeros_like(per_view))))
            poses.append(pose)
            weights.append((weights2d[a] + weights2d[b]) / 2.0)
            pair_ok.append(view_valid[a] & view_valid[b])
    errs = torch.stack(errs)
    errs = torch.where(torch.stack(pair_ok), errs, torch.full_like(errs, float("inf")))
    best = torch.argmin(errs)
    return torch.stack(poses)[best], torch.stack(weights)[best]


def fuse_pairwise_humans(points, point_valid, weights, costs, person_valid=None):
    """Cost-weighted fusion of per-pair triangulations into one 3D person.
    Returns ((J, 3) joints, (J,) weights, (J,) bool valid)."""
    N = points.shape[0]
    if person_valid is None:
        person_valid = torch.ones(N, dtype=torch.bool, device=points.device)
    count = person_valid.sum()
    total_cost = torch.sum(torch.where(person_valid, costs, torch.zeros_like(costs)))
    multi = (total_cost - costs) / torch.clamp(
        total_cost * torch.clamp(count - 1, min=1), min=1e-12
    )
    w_person = torch.where(count == 1, torch.ones_like(multi), multi)
    contrib = point_valid & person_valid[:, None]
    human3d = torch.sum(
        torch.where(contrib[..., None], points * w_person[:, None, None],
                    torch.zeros_like(points)),
        dim=0,
    )
    n_contrib = contrib.sum(dim=0)
    weight3d = torch.sum(torch.where(contrib, weights, torch.zeros_like(weights)),
                         dim=0) / torch.clamp(n_contrib, min=1)
    return human3d, weight3d, n_contrib > 0
