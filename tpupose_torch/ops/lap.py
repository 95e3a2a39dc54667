"""Linear assignment (Hungarian) on the tensor's own device.

Counterpart of `tpupose/ops/lap.py`: the Jonker-Volgenant shortest
augmenting path over fixed-size tensors, with the smaller dimension as the
augmenting rows and a padding cost scaled to the matrix (a fixed huge pad
mixes pad-scale and cost-scale values in the f32 potentials and erases small
affinity differences).

The JAX package's `while_loop`s become Python loops. Each loop test reads
one device value on the host (`host_bool`), which on a CUDA tensor is a
device -> host sync; `host_syncs` counts them.
"""
from __future__ import annotations

import torch

#: Host reads of device values made by the LAP and the tracker's branches.
host_syncs = 0


def host_bool(x) -> bool:
    """bool() of a 0-d tensor, counted in `host_syncs`."""
    global host_syncs
    host_syncs += 1
    return bool(x)


def solve_lap(cost):
    """Solve the rectangular LAP (minimize), assigning every row.

    Args:
      cost: (R, C) float tensor with R <= C, all entries finite.

    Returns:
      row_of_col (C,) int64 (-1 if none) and col_of_row (R,) int64.
    """
    cost = cost.to(torch.float32)
    R, C = cost.shape
    assert R <= C, f"solve_lap needs R <= C, got {tuple(cost.shape)}"
    dev = cost.device
    # 0-d device tensors come from fills: torch.tensor(x, device=...) would
    # copy from the host and wait for the stream.
    inf = torch.full((), 3e38, dtype=torch.float32, device=dev)
    VIRT = C  # virtual start column
    u = torch.zeros(R + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(C + 1, dtype=torch.float32, device=dev)
    p = torch.full((C + 1,), -1, dtype=torch.long, device=dev)
    ones = torch.ones(C + 1, dtype=torch.float32, device=dev)
    trash = torch.full((), R, dtype=torch.long, device=dev)
    for i in range(R):
        p[VIRT] = i
        minv = torch.full((C + 1,), 3e38, dtype=torch.float32, device=dev)
        used = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        way = torch.full((C + 1,), VIRT, dtype=torch.long, device=dev)
        j0 = torch.full((), VIRT, dtype=torch.long, device=dev)
        # p[VIRT] = i >= 0, so the first loop test always passes.
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0, :] - u[i0] - v[:C]
            better = (cur < minv[:C]) & ~used[:C]
            minv[:C] = torch.where(better, cur, minv[:C])
            way[:C] = torch.where(better, j0, way[:C])
            reach = torch.where(used[:C], inf, minv[:C])
            j1 = torch.argmin(reach)
            delta = reach[j1]
            # u[p[j]] += delta for used columns j (p is injective on them).
            row_idx = torch.where(used, p, trash)
            bump = torch.zeros(R + 1, dtype=torch.float32, device=dev)
            bump.index_add_(0, row_idx, ones)
            u = u + delta * bump
            v = v - delta * used.to(torch.float32)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
            if not host_bool(p[j0] != -1):
                break
        # Augment along the alternating path back to the virtual column.
        while host_bool(j0 != VIRT):
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    row_of_col = p[:C].clone()
    col_of_row = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
    col_of_row[torch.where(row_of_col >= 0, row_of_col, trash)] = torch.arange(
        C, dtype=torch.long, device=dev)
    return row_of_col, col_of_row[:R]


def masked_lap(cost, row_valid, col_valid, maximize=False):
    """LAP over a masked block of a fixed (R, C) matrix.

    Invalid rows, columns and entries get the pad cmax + n * span + 1, so
    the optimum never trades a real pair for a pad. Assignments to invalid
    columns or from invalid rows come back as -1.

    Returns:
      col_of_row: (R,) int64, -1 for unassigned or invalid rows.
    """
    c = cost.to(torch.float32)
    R, C = c.shape
    if maximize:
        c = -c
    ok = row_valid[:, None] & col_valid[None, :]
    has = ok.any()
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    cmax = torch.where(has, torch.amax(torch.where(ok, c, -torch.inf)), zero)
    cmin = torch.where(has, torch.amin(torch.where(ok, c, torch.inf)), zero)
    pad = cmax + (cmax - cmin) * min(R, C) + 1.0
    c = torch.where(ok, c, pad)
    if R <= C:
        _, col_of_row = solve_lap(c)
    else:
        # Smaller dimension on the rows; the transpose's row_of_col is the
        # original column assigned to each original row.
        col_of_row, _ = solve_lap(c.T)
    assigned_ok = (
        row_valid
        & (col_of_row >= 0)
        & col_valid[col_of_row.clamp(min=0)]
    )
    return torch.where(assigned_ok, col_of_row, -1)
