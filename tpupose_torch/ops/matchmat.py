"""Match-matrix utilities for the CSA / match-matrix person matcher.

Counterpart of `tpupose/ops/matchmat.py`: the reference's
`transform_closure` and `proj2dpam` (`src/utils/calculate.py:82-145`), the
core math of its match-matrix path (named by the CSA_* config keys; the
iterative tracker does not use them). The JAX package's scans and
`lax.while_loop` become Python loops with the same stopping rule.

`transform_closure` deviation (documented, deliberate, as in the JAX
package): the reference's triple loop writes
`temp[i][j] = X[i,j] or (X[i,k] and X[k,j])` reading only the ORIGINAL
matrix and overwriting `temp` wholesale each k, so only k = N-1 has any
effect. This computes the real transitive closure (boolean products to a
fixpoint), the semantics the surrounding algorithm assumes; on the
symmetric, thresholded affinity matrices the matcher feeds it the two
agree.
"""
from __future__ import annotations

import math

import torch


def transform_closure(x_bin):
    """Binary relation matrix -> cluster assignment ("permutation") matrix.

    Args:
      x_bin: (N, N) bool/0-1 relation matrix.

    Returns:
      (N, N) float32 match matrix M with M[j, i] = 1 iff element j belongs
      to the cluster whose representative is i (the smallest-index row that
      first claimed j, as the reference's sequential scan,
      `src/utils/calculate.py:94-103`).
    """
    closure = torch.as_tensor(x_bin).bool()
    n = closure.shape[0]
    # Transitive closure by doubling: closure = OR of powers of x.
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        c = closure.float()
        closure = closure | ((c @ c) > 0)
    # Sequential representative extraction (order matters: a row claims all
    # its relatives only if it was not itself claimed by an earlier row).
    vis = torch.zeros(n, dtype=torch.bool, device=closure.device)
    match = torch.zeros((n, n), dtype=torch.float32, device=closure.device)
    for i in range(n):
        claim = closure[i] & ~vis[i]
        vis = vis | claim
        match[:, i] = torch.where(claim, 1.0, match[:, i])
    return match


def proj2pav(y):
    """Project a vector onto {x >= 0, sum(x) <= 1} (capped simplex),
    `src/utils/calculate.py:133-145`."""
    y = torch.clamp(y, min=0.0)
    n = y.shape[0]
    u = torch.sort(y, descending=True).values
    sv = torch.cumsum(u, dim=0)
    idx = torch.arange(n, device=y.device)
    to_find = u > (sv - 1.0) / (idx + 1).to(y.dtype)
    # index of the LAST true entry (reference: torch.nonzero(...)[-1])
    rho = torch.max(torch.where(to_find, idx, -1))
    rho_c = torch.clamp(rho, 0, n - 1)
    theta = torch.clamp((sv[rho_c] - 1.0) / (rho_c + 1.0), min=0.0)
    projected = torch.clamp(y - theta, min=0.0)
    return torch.where(torch.sum(y) < 1.0, y, projected)


def _proj_rows(x):
    return torch.stack([proj2pav(row) for row in x])


def proj2dpam_iterations(y, tol=1e-4, max_iter=10):
    """`proj2dpam`, also returning the number of iterations it ran."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = y
    i2 = torch.zeros_like(y)
    it, chg = 0, math.inf
    while it < max_iter and chg >= tol:
        x1 = _proj_rows(y + i2)
        i1 = x1 - (y + i2)
        x2 = _proj_rows((y + i1).T).T
        i2 = x2 - (y + i1)
        chg = float(torch.mean(torch.abs(x2 - x)))
        x, it = x2, it + 1
    return x, it


def proj2dpam(y, tol=1e-4, max_iter=10):
    """Project a score matrix toward a doubly-stochastic-ish matrix by
    Dykstra-style alternating row / column capped-simplex projections
    (`src/utils/calculate.py:105-121`), until the mean change falls below
    `tol` or after `max_iter` iterations.

    Args:
      y: (N, M) score matrix.
    Returns:
      (N, M) projected matrix (rows and columns in [0, 1], sums <= 1).
    """
    return proj2dpam_iterations(y, tol, max_iter)[0]
