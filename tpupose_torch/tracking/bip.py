"""Binary-integer-programming clique partitioning (alternative matcher).

Counterpart of `tpupose/tracking/bip.py`, host numpy and scipy. Port of the reference's correlation-clustering BIP solver
(`src/tracking/binary_integer_programming.py:13-209`): maximize
sum_ij affinity[i,j] * x_ij over pair indicators subject to transitivity
x_ij + x_ik - x_jk <= 1 (all index permutations), solved as an LP relaxation
(the reference uses scipy linprog despite its cvxopt/GLPK imports), with
+/-inf affinities frozen to 1/0, and clusters extracted by label
propagation. This is the 'BIP' INIT_METHOD alternative to the shipped greedy
hypothesis builder (all three reference YAMLs use INIT_METHOD: 'GD'); the
tracker does not call it.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linprog

from tpupose_torch.geometry import epipolar_distance_matrix


def solve_clique_partition(affinity: np.ndarray):
    """Cluster nodes by pairwise affinity.

    Args:
      affinity: (N, N) symmetric scores; > 0 pulls nodes together, < 0 apart;
        +/-inf entries are frozen to joined/separated.

    Returns:
      clusters: list of lists of node indices (each sorted ascending).
    """
    n = affinity.shape[0]
    if n == 0:
        return []
    if n == 1:
        return [[0]]
    pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
    idx = {p: k for k, p in enumerate(pairs)}
    m = len(pairs)

    w = np.array([affinity[i, j] for i, j in pairs], np.float64)
    frozen_pos = np.isposinf(w)
    frozen_neg = np.isneginf(w)
    w[frozen_pos] = 0.0
    w[frozen_neg] = 0.0

    # Transitivity: for each ordered triple, x_ij + x_ik - x_jk <= 1.
    rows = []
    for i in range(n - 2):
        for j in range(i + 1, n - 1):
            for k in range(j + 1, n):
                ij, ik, jk = idx[(i, j)], idx[(i, k)], idx[(j, k)]
                for a, b, c in ((ij, ik, jk), (ij, jk, ik), (ik, jk, ij)):
                    row = np.zeros(m)
                    row[a] = 1
                    row[b] = 1
                    row[c] = -1
                    rows.append(row)
    A_ub = np.stack(rows) if rows else None
    b_ub = np.ones(len(rows)) if rows else None

    bounds = []
    for k in range(m):
        if frozen_pos[k]:
            bounds.append((1.0, 1.0))
        elif frozen_neg[k]:
            bounds.append((0.0, 0.0))
        else:
            bounds.append((0.0, 1.0))

    res = linprog(-w, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    x = res.x if res.success else np.zeros(m)

    # Label propagation over rounded pair decisions.
    labels = np.arange(n)
    for k, (i, j) in enumerate(pairs):
        if x[k] > 0.5:
            li, lj = labels[i], labels[j]
            if li != lj:
                labels[labels == lj] = li
    clusters = {}
    for node, lab in enumerate(labels):
        clusters.setdefault(lab, []).append(node)
    return sorted(clusters.values(), key=lambda c: c[0])


def bip_matching(cameras_F, cam_of_node, poses, threshold=40.0):
    """Cross-view clustering of 2D poses (the reference's `BIP_matching`,
    `src/utils/matching.py:234-241`): affinity = 1 - mean epipolar
    distance / threshold, same-camera pairs forbidden (-inf).

    Args:
      cameras_F: (C, C, 3, 3) fundamental matrices.
      cam_of_node: (N,) camera index of each pose.
      poses: (N, J, 3) 2D poses (x, y, score).

    Returns:
      clusters: list of node-index lists.
    """
    cam_of_node = np.asarray(cam_of_node)
    F_pairs = torch.as_tensor(np.asarray(cameras_F)[np.ix_(cam_of_node, cam_of_node)])
    _, mean = epipolar_distance_matrix(F_pairs.float(),
                                       torch.as_tensor(np.asarray(poses)).float())
    affinity = 1.0 - mean.numpy() / threshold
    same_cam = np.equal.outer(cam_of_node, cam_of_node)
    affinity[same_cam] = -np.inf
    np.fill_diagonal(affinity, 0.0)
    return solve_clique_partition(affinity)
