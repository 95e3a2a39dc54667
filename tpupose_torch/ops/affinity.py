"""Appearance / geometry affinity utilities (CSA matcher building blocks).

Counterpart of `tpupose/ops/affinity.py`: working versions of the
reference's partially broken ReID affinity helpers
(`src/utils/matching.py:153-231`), a normalized geometry affinity over
epiline distances and embedding affinities for appearance features. They
back the config's CSA_* matcher options
(`configs/CampusSeq1/model_configs.yaml:67-69`), which the reference never
wires up; the tracker does not call them.
"""
from __future__ import annotations

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _zscore_sigmoid(d, scale, eps):
    z = -(d - d.mean()) / (d.std(correction=0) + eps)
    return 1.0 / (1.0 + torch.exp(-scale * z))


def normalized_geometry_affinity(distance_matrix, eps=1e-5):
    """Z-score + sigmoid mapping of a distance matrix to (0, 1) affinities
    (the reference's `geometry_affinity` tail, `src/utils/matching.py:182-183`).
    """
    return _zscore_sigmoid(_f32(distance_matrix), 5.0, eps)


def pairwise_sq_distances(x, y):
    """Squared euclidean distances between feature rows, (N, M)."""
    x = _f32(x).reshape(len(x), -1)
    y = _f32(y).reshape(len(y), -1)
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    return x2 + y2.T - 2.0 * (x @ y.T)


def embedding_affinity(query, gallery, metric="cosine"):
    """Appearance affinity in [0, 1] (fixed version of the reference's
    `embedding_affinity`, which referenced an undefined `cdist`,
    `src/utils/matching.py:216-231`)."""
    q = _f32(query).reshape(len(query), -1)
    g = _f32(gallery).reshape(len(gallery), -1)
    if metric == "cosine":
        qn = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-12)
        gn = g / torch.linalg.norm(g, dim=1, keepdim=True).clamp(min=1e-12)
        cost = 1.0 - qn @ gn.T
    else:
        cost = torch.sqrt(torch.clamp(pairwise_sq_distances(q, g), min=0.0))
    return 1.0 - torch.clamp(cost, min=0.0)


def pairwise_affinity(query, gallery, scale=5.0, eps=1e-5):
    """Z-scored sigmoid affinity over squared distances (the reference's
    torch `pairwise_affinity`, `src/utils/matching.py:198-214`)."""
    return _zscore_sigmoid(pairwise_sq_distances(query, gallery), scale, eps)
