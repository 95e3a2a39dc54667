"""Linear assignment (Hungarian) on the tensor's own device.

Counterpart of `tpupose/ops/lap.py`: the Jonker-Volgenant shortest
augmenting path over fixed-size tensors, with the smaller dimension as the
augmenting rows and a padding cost scaled to the matrix (a fixed huge pad
mixes pad-scale and cost-scale values in the f32 potentials and erases small
affinity differences).

* `solve_lap` and `masked_lap_plain` are the plain torch versions. The JAX
  package's `while_loop`s become Python loops, and each loop test reads one
  device value on the host (`host_bool`), counted in `host_syncs`.
* `masked_lap_cuda` solves a batch of masked problems in one launch of the
  hand-written kernel K3 (`tpupose_torch/csrc/lap.cu`), counted in
  `launches`, with no host read.
* `masked_lap` is what the tracker calls: the op `tpupose_torch::masked_lap`
  over (..., R, C) costs. A CPU tensor goes to the plain version, a CUDA
  tensor to K3, which raises rather than fall back; its vmap rule folds
  the vmapped dimensions into the batch, so `torch.func.vmap` of a caller
  (the multi-stream tracker) is still one launch.
"""
from __future__ import annotations

import ctypes

import torch

#: Host reads of device values made by the plain LAP (reset freely).
host_syncs = 0
#: Dijkstra steps taken by the plain LAP (reset freely): one per pass of
#: `solve_lap`'s inner loop, the chain of dependent steps K3 runs too.
dijkstra_steps = 0
#: Launches of K3 (reset freely; read by chip_smoke.py).
launches = 0
#: The plain version's INF, also the kernel's.
INF = 3e38
#: The JAX package's fixed padding cost, kept for its users: padding here is
#: scaled to each matrix (`masked_lap_plain`), since a fixed 1e6 leaves f32
#: potentials a resolution of ~0.06 and erases affinity differences of ~1e-2.
PAD_COST = 1e6


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
    global dijkstra_steps
    cost = cost.to(torch.float32)
    R, C = cost.shape
    assert R <= C, f"solve_lap needs R <= C, got {tuple(cost.shape)}"
    dev = cost.device
    # 0-d device tensors come from fills: torch.tensor(x, device=...) would
    # copy from the host and wait for the stream.
    inf = torch.full((), INF, dtype=torch.float32, device=dev)
    VIRT = C  # virtual start column
    u = torch.zeros(R + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(C + 1, dtype=torch.float32, device=dev)
    p = torch.full((C + 1,), -1, dtype=torch.long, device=dev)
    ones = torch.ones(C + 1, dtype=torch.float32, device=dev)
    trash = torch.full((), R, dtype=torch.long, device=dev)
    for i in range(R):
        p[VIRT] = i
        minv = torch.full((C + 1,), INF, dtype=torch.float32, device=dev)
        used = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        way = torch.full((C + 1,), VIRT, dtype=torch.long, device=dev)
        j0 = torch.full((), VIRT, dtype=torch.long, device=dev)
        # p[VIRT] = i >= 0, so the first loop test always passes.
        while True:
            dijkstra_steps += 1
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


def _masked_lap_one(cost, row_valid, col_valid, maximize):
    """`masked_lap_plain` for one (R, C) problem."""
    c = cost.to(torch.float32)
    R, C = c.shape
    if R * C == 0:
        return torch.full((R,), -1, dtype=torch.long, device=c.device)
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


def masked_lap_plain(cost, row_valid, col_valid, maximize=False):
    """LAP over masked blocks of fixed (R, C) matrices, one at a time.

    Invalid rows, columns and entries get the pad cmax + n * span + 1, so
    the optimum never trades a real pair for a pad. Assignments to invalid
    columns or from invalid rows come back as -1.

    Args:
      cost: (..., R, C) costs (scores if `maximize`), finite where valid.
      row_valid: (..., R) bool; col_valid: (..., C) bool, the same leading
        shape.

    Returns:
      col_of_row: (..., R) int64, -1 for unassigned or invalid rows.
    """
    R, C = cost.shape[-2:]
    lead = cost.shape[:-2]
    batch = lead.numel()
    cost = cost.reshape(batch, R, C)
    row_valid = row_valid.reshape(batch, R)
    col_valid = col_valid.reshape(batch, C)
    out = [_masked_lap_one(cost[b], row_valid[b], col_valid[b], maximize)
           for b in range(batch)]
    if not out:
        return torch.full(lead + (R,), -1, dtype=torch.long, device=cost.device)
    return torch.stack(out).reshape(lead + (R,))


def _kernel():
    from tpupose_torch import kernels

    lib = kernels.library("lap")
    fn = lib.tpupose_masked_lap
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tpupose_masked_lap_warps.argtypes = [ctypes.c_int] * 2
        lib.tpupose_masked_lap_warps.restype = ctypes.c_int
        lib.tpupose_empty_launch.argtypes = [ctypes.c_void_p]
        lib.tpupose_empty_launch.restype = ctypes.c_int
        lib.tpupose_step_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.tpupose_step_chain.restype = ctypes.c_int
    return lib


def _stream(index):
    """The raw handle of device `index`'s current stream. The public
    `torch.cuda.current_stream().cuda_stream` builds a Stream object first,
    which costs more host time than the rest of a K3 launch's binding."""
    return torch._C._cuda_getCurrentRawStream(index)


def empty_launch():
    """One launch of an empty kernel on the current stream (the launch
    cost K3's small batches sit on; measured by chip_smoke.py)."""
    rc = _kernel().tpupose_empty_launch(_stream(torch.cuda.current_device()))
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def step_chain(n, out):
    """One launch of a warp that runs `n` dependent minimal Dijkstra steps
    (shared load, `__reduce_min_sync`, select) into `out`, 32 int32 on the
    card: the card's floor under one K3 step (measured by chip_smoke.py)."""
    if out.device.type != "cuda" or out.dtype != torch.int32 or out.numel() < 32:
        raise ValueError("step_chain needs 32 int32 on a CUDA device")
    rc = _kernel().tpupose_step_chain(int(n), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step chain kernel launch failed: CUDA error {rc}")


def masked_lap_cuda(cost, row_valid, col_valid, maximize=False):
    """`masked_lap_plain` over every problem of the batch in one launch of
    K3. Takes (..., R, C) float32 costs and (..., R) / (..., C) bool masks
    with one leading shape on one CUDA device; raises on anything else, on
    a shape the kernel does not take (more than 256 columns after
    orientation, or a problem above its shared memory) and on a failed
    launch. Launches on the current stream and does not synchronize."""
    global launches
    if not (cost.device.type == "cuda" and row_valid.device == cost.device
            and col_valid.device == cost.device):
        raise ValueError(f"masked_lap_cuda needs CUDA tensors on one device, got "
                         f"{cost.device}, {row_valid.device} and {col_valid.device}")
    if cost.dtype != torch.float32 or row_valid.dtype != torch.bool \
            or col_valid.dtype != torch.bool:
        raise TypeError(f"masked_lap_cuda needs float32 costs and bool masks, got "
                        f"{cost.dtype}, {row_valid.dtype} and {col_valid.dtype}")
    if cost.dim() < 2:
        raise ValueError(f"masked_lap_cuda needs (..., R, C) costs, got "
                         f"{tuple(cost.shape)}")
    R, C = cost.shape[-2:]
    lead = cost.shape[:-2]
    if row_valid.shape != lead + (R,) or col_valid.shape != lead + (C,):
        raise ValueError(f"masked_lap_cuda: masks {tuple(row_valid.shape)} and "
                         f"{tuple(col_valid.shape)} do not fit costs {tuple(cost.shape)}")
    out = torch.empty(lead + (R,), dtype=torch.long, device=cost.device)
    batch = lead.numel()
    if batch == 0 or R == 0:
        return out
    if C == 0:
        return out.fill_(-1)
    lib = _kernel()
    if lib.tpupose_masked_lap_warps(R, C) <= 0:
        raise ValueError(f"masked_lap_cuda: K3 takes at most 256 columns after "
                         f"orientation and 48 KB of shared memory a problem, "
                         f"got ({R}, {C})")
    cost, row_valid, col_valid = (t if t.is_contiguous() else t.contiguous()
                                  for t in (cost, row_valid, col_valid))
    args = (cost.data_ptr(), row_valid.data_ptr(), col_valid.data_ptr(), out.data_ptr(),
            batch, R, C, int(bool(maximize)))
    index = cost.device.index
    with torch.cuda.device(index):
        rc = lib.tpupose_masked_lap(*args, _stream(index))
    if rc != 0:
        raise RuntimeError(f"masked_lap kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


@torch.library.custom_op("tpupose_torch::masked_lap", mutates_args=(),
                         device_types="cpu")
def _masked_lap_op(cost: torch.Tensor, row_valid: torch.Tensor,
                   col_valid: torch.Tensor, maximize: bool) -> torch.Tensor:
    return masked_lap_plain(cost, row_valid, col_valid, maximize)


@_masked_lap_op.register_kernel("cuda")
def _masked_lap_op_cuda(cost, row_valid, col_valid, maximize):
    return masked_lap_cuda(cost, row_valid, col_valid, maximize)


@_masked_lap_op.register_fake
def _masked_lap_op_fake(cost, row_valid, col_valid, maximize):
    return cost.new_empty(cost.shape[:-1], dtype=torch.long)


@_masked_lap_op.register_vmap
def _masked_lap_op_vmap(info, in_dims, cost, row_valid, col_valid, maximize):
    """The vmapped dimension becomes the leading batch dimension."""
    def lead(x, dim):
        if dim is None:
            return x.expand((info.batch_size,) + x.shape)
        return x.movedim(dim, 0)

    cost_d, row_d, col_d, _ = in_dims
    return _masked_lap_op(lead(cost, cost_d), lead(row_valid, row_d),
                          lead(col_valid, col_d), maximize), 0


def masked_lap(cost, row_valid, col_valid, maximize=False):
    """LAP over masked blocks of fixed (R, C) matrices (`masked_lap_plain`
    on a CPU tensor, K3 on a CUDA tensor).

    Args:
      cost: (..., R, C) costs (scores if `maximize`), finite where valid.
      row_valid: (..., R) bool; col_valid: (..., C) bool; both broadcast to
        the costs' leading shape.

    Returns:
      col_of_row: (..., R) int64, -1 for unassigned or invalid rows.
    """
    cost = cost.to(torch.float32)
    R, C = cost.shape[-2:]
    lead = cost.shape[:-2]
    row_valid = row_valid.to(torch.bool).expand(lead + (R,))
    col_valid = col_valid.to(torch.bool).expand(lead + (C,))
    return _masked_lap_op(cost, row_valid, col_valid, bool(maximize))
