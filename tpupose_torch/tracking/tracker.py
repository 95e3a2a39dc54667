"""Fixed-capacity multi-view 3D pose tracker.

Counterpart of `tpupose/tracking/tracker.py`, with the same semantics: the
state is a NamedTuple of tensors with static capacities (max_tracks,
max_dets, max_hyp) and validity masks. Where the JAX package vmaps over
cameras, tracks or hypotheses, this module writes the batch dimension out.

`tracker_step` is the eager step. It reads nothing on the host and every
shape in it is static, so on CUDA it is captured once as a CUDA graph
(`runtime.graphs`) and replayed each frame: `make_step_fn` is the
counterpart of the JAX package's jitted step, and `track_clip` of its
`lax.scan`, a replay a frame into preallocated (F, ...) outputs. On the
CPU the same buffers run the eager step. `torch.func.vmap` batches the
step over streams (`tpupose_torch.parallel.streams`). The LAPs go through
`ops.lap.masked_lap` (kernel K3 on CUDA): one call over all cameras in the
association, one per camera in the hypothesis init. The JAX package's two
`lax.cond`s become what they are under vmap: a camera with no qualified
unmatched detections runs its masked LAP and changes nothing, and the
hypothesis build is selected with `torch.where` when there are
hypotheses. Tensors made inside the step are written out of place, so
that a vmapped step never writes batched values into an unbatched tensor.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import torch

from tpupose_torch.geometry import (
    CameraSet,
    back_project_rays,
    epipolar_distance_matrix,
    line_point_distance_3d,
    project_points,
    triangulate_joints,
)
from tpupose_torch.ops.lap import masked_lap
from tpupose_torch.ops.smoothing import smooth_last_pose
from tpupose_torch.runtime.graphs import captured_step
from tpupose_torch.utils import timing

NEVER = -(10**8)  # "no 2D pose stored" timestamp sentinel

#: The reference hardcodes the association joint gate to 10 for every
#: dataset although its own comment says Campus should use 14; the default
#: is the shipped value, and configs select Campus's by the JOINT_GATE key.
REFERENCE_JOINT_GATE = 10
CAMPUS_JOINT_GATE = 14


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracker configuration; fields and defaults as in the JAX
    package's `TrackerConfig` (its docstrings explain each one)."""

    num_cameras: int
    num_joints: int = 17
    max_tracks: int = 16
    max_dets: int = 16
    max_hyp: int = 40
    hist_len: int = 12
    conf_threshold: float = 0.4
    epi_threshold: float = 25.0
    init_threshold: float = 15.0
    joint_threshold: float = 15.0
    n_init: int = 3
    max_age: int = 10
    alpha2d: float = 30.0
    lambda_a: float = 3.0
    lambda_t: float = 5.0
    sigma: float = 0.6
    arm_sigma: float = 0.8
    joint_gate: int = REFERENCE_JOINT_GATE
    update_window: int = 3
    arm_joints: tuple = (9, 10)
    resurrect_window: int = 0
    resurrect_dist: float = 0.5
    resurrect_speed: float = 0.06
    tie_eps: float = 3e-3


class TrackerState(NamedTuple):
    """Struct-of-arrays track store. T = max_tracks, C = cameras, J = joints,
    H = hist_len, G = max_tracks (graveyard ring)."""

    active: torch.Tensor       # (T,) bool
    confirmed: torch.Tensor    # (T,) bool
    track_id: torch.Tensor     # (T,) int32
    hits: torch.Tensor         # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    already_update: torch.Tensor     # (T,) bool
    pose2d: torch.Tensor       # (T, C, J, 3)
    pose2d_time: torch.Tensor  # (T, C) int32, NEVER if unset
    hist_pose: torch.Tensor    # (T, H, J, 3)
    hist_time: torch.Tensor    # (T, H) int32
    hist_count: torch.Tensor   # (T,) int32
    last_n_views: torch.Tensor  # (T, J) int32
    velocity: torch.Tensor     # (T, J, 3)
    next_id: torch.Tensor      # () int32
    grave_id: torch.Tensor     # (G,) int32, -1 = empty
    grave_pose: torch.Tensor   # (G, J, 3)
    grave_time: torch.Tensor   # (G,) int32
    grave_del: torch.Tensor    # (G,) int32
    grave_ptr: torch.Tensor    # () int32

    def to(self, device) -> "TrackerState":
        return TrackerState(*(t.to(device) for t in self))


class FrameOutput(NamedTuple):
    """Per-frame harvest: confirmed, just-updated tracks."""

    valid: torch.Tensor      # (T,) bool
    track_id: torch.Tensor   # (T,) int32
    pose3d: torch.Tensor     # (T, J, 3)
    n_views: torch.Tensor    # (T, J) int32
    pose2d: torch.Tensor     # (T, C, J, 3)
    pose2d_now: torch.Tensor  # (T, C) bool


def init_state(cfg: TrackerConfig, device=None) -> TrackerState:
    """A fresh tracker state, on CUDA unless `device` says otherwise."""
    from tpupose_torch.pipeline.facade import resolve_device

    device = resolve_device(device)
    T, C, J, H = cfg.max_tracks, cfg.num_cameras, cfg.num_joints, cfg.hist_len
    i32, f32 = torch.int32, torch.float32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return TrackerState(
        active=full((T,), False, torch.bool),
        confirmed=full((T,), False, torch.bool),
        track_id=full((T,), -1, i32),
        hits=full((T,), 0, i32),
        time_since_update=full((T,), 0, i32),
        already_update=full((T,), False, torch.bool),
        pose2d=full((T, C, J, 3), 0.0, f32),
        pose2d_time=full((T, C), NEVER, i32),
        hist_pose=full((T, H, J, 3), 0.0, f32),
        hist_time=full((T, H), NEVER, i32),
        hist_count=full((T,), 0, i32),
        last_n_views=full((T, J), 0, i32),
        velocity=full((T, J, 3), 0.0, f32),
        next_id=full((), 0, i32),
        grave_id=full((T,), -1, i32),
        grave_pose=full((T, J, 3), 0.0, f32),
        grave_time=full((T,), NEVER, i32),
        grave_del=full((T,), NEVER, i32),
        grave_ptr=full((), 0, i32),
    )


def _rows(x, idx):
    """x[b, idx[b]] for a (B, N, ...) tensor and (B,) indices."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _last_hist(state: TrackerState):
    """Latest 3D pose and its timestamp per track slot."""
    idx = torch.clamp(state.hist_count - 1, min=0)
    return _rows(state.hist_pose, idx), _rows(state.hist_time, idx)


def _set_rows(x, slot, values):
    """x.at[slot].set(values, mode="drop") with slot == len(x) as the
    dropped sentinel (an extra trash row, sliced off). `values` is a tensor
    of rows or a Python scalar."""
    n = x.shape[0]
    slot = torch.where((slot >= 0) & (slot < n), slot, n).long()
    ext = torch.cat([x, x[:1]])
    if not torch.is_tensor(values):  # a fill: a host scalar would be copied
        values = torch.full((), values, dtype=x.dtype, device=x.device)
    ext[slot] = values.to(x.dtype).expand((slot.shape[0],) + x.shape[1:])
    return ext[:n]


def _set_at(x, pos, column, values):
    """x.at[pos, column].set(values, mode="drop") for (N, C, ...) x."""
    n = x.shape[0]
    pos = torch.where((pos >= 0) & (pos < n), pos, n).long()
    ext = torch.cat([x, x[:1]])
    ext[pos, column] = values.to(x.dtype)
    return ext[:n]


def _one_hot_mask(index, size):
    """(B, size) bool rows with index[b] set (dropped if out of range)."""
    return torch.arange(size, device=index.device)[None, :] == index[:, None]


def _hit_mask(index, size):
    """(..., size) bool: entry k set where some index[..., b] == k (indices
    out of range are dropped); the out-of-place `.at[index].set(True)`."""
    return (index[..., :, None] == torch.arange(size, device=index.device)).any(dim=-2)


# --------------------------------------------------------------------------
# Phase 1: per-camera association
# --------------------------------------------------------------------------

def _associate(cfg: TrackerConfig, cams: CameraSet, state: TrackerState,
               dets, det_mask, frame_id):
    """Returns (matched (C, T) bool, match_col (C, T) int64,
    unmatched (C, D) bool)."""
    D = cfg.max_dets
    tracks_pose, last_time = _last_hist(state)
    dt = torch.where(state.active, frame_id - last_time, 1).to(torch.float32)
    # Golden-ratio hash of the persistent id (f32, floor-mod).
    tie_fid = torch.remainder(
        state.track_id.to(torch.float32) * 0.6180339887498949, 1.0)

    reproj = project_points(cams.P[:, None], tracks_pose[None])  # (C, T, J, 2)
    d = torch.linalg.vector_norm(
        reproj[:, :, None] - dets[:, None, :, :, :2], dim=-1)  # (C, T, D, J)
    scores = 1.0 - d / (cfg.alpha2d * dt[None, :, None, None])
    pos = scores > 0
    npos = pos.sum(dim=-1)
    aff = torch.where(pos, scores, 0.0).sum(dim=-1) / torch.clamp(npos, min=1)
    aff = torch.where(npos > cfg.joint_gate, aff, 0.0)
    aff = aff / torch.exp(cfg.lambda_a * dt[None, :, None])  # (C, T, D)
    if cfg.tie_eps > 0.0:
        g = (dets[..., 0].mean(dim=-1) * 1e-3
             + dets[..., 1].mean(dim=-1) * 1.3e-3)  # (C, D)
        bias = cfg.tie_eps * tie_fid[None, :, None] * g[:, None, :]
        aff_sel = torch.where(aff > 0, aff + bias, aff)
    else:
        aff_sel = aff
    # one LAP per camera, all in one call
    col = masked_lap(aff_sel, state.active, det_mask, maximize=True)  # (C, T)
    got = torch.gather(aff, 2, col.clamp(0, D - 1)[:, :, None])[:, :, 0]
    matched = (col >= 0) & (got > 0.0)
    claimed = _hit_mask(torch.where(matched, col, -1), D)  # (C, D)
    return matched, torch.where(matched, col, -1), det_mask & ~claimed


def _apply_matches(state: TrackerState, dets, matched, match_col, frame_id):
    """Write matched detections into the per-camera 2D store."""
    C, T = matched.shape
    sel = dets[torch.arange(C, device=dets.device)[:, None],
               match_col.clamp(min=0)]  # (C, T, J, 3)
    pose2d = torch.where(matched.T[:, :, None, None], sel.transpose(0, 1),
                         state.pose2d)
    pose2d_time = torch.where(matched.T, frame_id, state.pose2d_time)
    return state._replace(
        pose2d=pose2d, pose2d_time=pose2d_time,
        already_update=state.already_update | matched.any(dim=0),
    )


# --------------------------------------------------------------------------
# Phase 2: per-track 3D update
# --------------------------------------------------------------------------

def _greedy_update_keep(cfg, aff, raydist, view_valid):
    """mode='update' view dropping over (B, C, C, J) affinities: for
    upper-triangle pairs with affinity < 0, drop the view whose ray is
    farther from the motion-predicted joint. Returns (B, C, J) bool."""
    C, J = cfg.num_cameras, cfg.num_joints
    keep = [view_valid[:, c, None].expand(-1, J) for c in range(C)]
    for r in range(C):
        for c in range(r + 1, C):
            conflict = (aff[:, r, c] < 0) & keep[r] & keep[c]
            drop_r = raydist[:, r] > raydist[:, c]
            keep[r] = keep[r] & ~(conflict & drop_r)
            keep[c] = keep[c] & ~(conflict & ~drop_r)
    return torch.stack(keep, dim=1)


def _greedy_init_keep(cfg, aff, member):
    """mode='init': drop the view with the smaller affinity row-sum (sums
    fixed up front over member columns). (B, C, C, J), (B, C) -> (B, C, J)."""
    C, J = cfg.num_cameras, cfg.num_joints
    row_sums = torch.where(member[:, None, :, None], aff, 0.0).sum(dim=2)
    keep = [member[:, c, None].expand(-1, J) for c in range(C)]
    for r in range(C):
        for c in range(r + 1, C):
            conflict = (aff[:, r, c] < 0) & keep[r] & keep[c]
            drop_c = row_sums[:, r] > row_sums[:, c]
            keep[c] = keep[c] & ~(conflict & drop_c)
            keep[r] = keep[r] & ~(conflict & ~drop_c)
    return torch.stack(keep, dim=1)


def _update_tracks(cfg: TrackerConfig, cams: CameraSet, state: TrackerState,
                   frame_id):
    J, H = cfg.num_joints, cfg.hist_len
    s = state
    dt_c = frame_id - s.pose2d_time  # (T, C) int32
    view_valid = dt_c <= cfg.update_window
    can = s.active & s.already_update & (view_valid.sum(dim=1) >= 2)

    last_idx = torch.clamp(s.hist_count - 1, min=0)
    last_pose = _rows(s.hist_pose, last_idx)
    last_time = _rows(s.hist_time, last_idx)
    next_pose = last_pose + s.velocity * (
        frame_id - last_time).to(torch.float32)[:, None, None]

    Dm, _ = epipolar_distance_matrix(cams.F, s.pose2d, valid=view_valid)
    aff = 1.0 - Dm / cfg.joint_threshold  # (T, C, C, J)
    dirs = back_project_rays(cams.rk_inv, s.pose2d[..., :2])  # (T, C, J, 3)
    raydist = line_point_distance_3d(
        cams.center[:, None, :], dirs, next_pose[:, None])  # (T, C, J)

    keep = _greedy_update_keep(cfg, aff, raydist, view_valid)
    n_views = keep.sum(dim=1).to(torch.int32)  # (T, J)
    fail = (n_views < 2).sum(dim=1)
    ok = can & (fail * 3 <= J)

    weights = torch.where(view_valid, torch.exp(-cfg.lambda_t * dt_c), 0.0)
    pose3d, _ = triangulate_joints(cams.P, s.pose2d[..., :2], weights, keep,
                                   fallback=next_pose)

    # Smooth over history + candidate.
    ext_pose = torch.cat([s.hist_pose, torch.zeros_like(s.hist_pose[:, :1])], dim=1)
    at = _one_hot_mask(torch.clamp(s.hist_count, 0, H), H + 1)
    ext_pose = torch.where(at[:, :, None, None], pose3d[:, None], ext_pose)
    smoothed = smooth_last_pose(ext_pose, s.hist_count + 1, cfg.sigma,
                                cfg.arm_sigma, cfg.arm_joints)

    # Append + span-based prune.
    at = _one_hot_mask(torch.clamp(s.hist_count, max=H - 1), H)
    new_hist_pose = torch.where(at[:, :, None, None], smoothed[:, None], s.hist_pose)
    new_hist_time = torch.where(at, frame_id, s.hist_time)
    new_count = s.hist_count + 1
    span_over = frame_id - new_hist_time[:, 0] > cfg.max_age  # (T,)
    new_hist_pose = torch.where(span_over[:, None, None, None],
                                torch.roll(new_hist_pose, -1, dims=1), new_hist_pose)
    new_hist_time = torch.where(span_over[:, None],
                                torch.roll(new_hist_time, -1, dims=1), new_hist_time)
    new_count = torch.where(span_over, new_count - 1, new_count)

    # Velocity = mean of up to 5 most recent history diffs.
    diffs = new_hist_pose[:, 1:] - new_hist_pose[:, :-1]  # (T, H-1, J, 3)
    i = torch.arange(H - 1, device=diffs.device)[None, :]
    dmask = (i >= new_count[:, None] - 6) & (i <= new_count[:, None] - 2)
    n_diffs = torch.clamp(dmask.sum(dim=1), min=1)
    new_velocity = torch.where(dmask[:, :, None, None], diffs, 0.0).sum(
        dim=1) / n_diffs[:, None, None]

    # Success vs failure (mark_missed).
    okb = ok[:, None, None, None]
    hits = torch.where(ok, s.hits + 1, s.hits)
    tsu = torch.where(ok, 0, s.time_since_update)
    confirmed = s.confirmed | (ok & ~s.confirmed & (hits >= cfg.n_init))
    deleted = s.active & ~ok & (
        (~confirmed & ~s.already_update) | (tsu >= cfg.max_age))
    state = s._replace(
        active=s.active & ~deleted,
        confirmed=confirmed,
        hits=hits,
        time_since_update=tsu,
        hist_pose=torch.where(okb, new_hist_pose, s.hist_pose),
        hist_time=torch.where(ok[:, None], new_hist_time, s.hist_time),
        hist_count=torch.where(ok, new_count, s.hist_count),
        velocity=torch.where(ok[:, None, None], new_velocity, s.velocity),
        last_n_views=torch.where(ok[:, None], n_views, s.last_n_views),
    )
    if cfg.resurrect_window > 0:
        state = _bury_tracks(cfg, state, deleted & confirmed, frame_id)
    return state


def _bury_tracks(cfg: TrackerConfig, state: TrackerState, push, frame_id):
    """Push deleted confirmed tracks into the graveyard ring."""
    G = cfg.max_tracks
    last_pose, last_time = _last_hist(state)
    rank = torch.cumsum(push.to(torch.int32), 0) - 1
    pos = torch.where(push, torch.remainder(state.grave_ptr + rank, G), G)
    return state._replace(
        grave_id=_set_rows(state.grave_id, pos, state.track_id),
        grave_pose=_set_rows(state.grave_pose, pos, last_pose),
        grave_time=_set_rows(state.grave_time, pos, last_time),
        grave_del=_set_rows(state.grave_del, pos, frame_id),
        grave_ptr=torch.remainder(
            state.grave_ptr + push.sum().to(torch.int32), G).to(torch.int32),
    )


# --------------------------------------------------------------------------
# Phase 3: new-target initialization
# --------------------------------------------------------------------------

def _hom(p):
    return torch.cat([p[..., :2], torch.ones_like(p[..., :1])], dim=-1)


def _hypothesis_costs(cfg, cams, hyp_pose, hyp_member, cam_c, dets_c, det_bel):
    """Cost (MH, D) and veto (MH, D) of adding camera-c detections to the
    existing hypotheses."""
    Fm = cams.F[:, cam_c]  # (C, 3, 3): F[member_cam, det_cam]
    mem_h = _hom(hyp_pose)  # (MH, C, J, 3)
    det_h = _hom(dets_c)    # (D, J, 3)

    lines_a = torch.einsum("mik,djk->mdji", Fm, det_h)  # (C, D, J, 3)
    na = torch.sqrt(torch.sum(lines_a[..., :2] ** 2, dim=-1))
    na = torch.where(na == 0, 1.0, na)
    d_a = torch.abs(torch.einsum("hmji,mdji->hmdj", mem_h, lines_a)) / na[None]
    lines_b = torch.einsum("mki,hmjk->hmji", Fm, mem_h)  # (MH, C, J, 3)
    nb = torch.sqrt(torch.sum(lines_b[..., :2] ** 2, dim=-1))
    nb = torch.where(nb == 0, 1.0, nb)
    d_b = torch.abs(torch.einsum("djk,hmjk->hmdj", det_h, lines_b)) / nb[:, :, None, :]

    s_mem = hyp_pose[..., 2]  # (MH, C, J)
    s_det = dets_c[..., 2]    # (D, J)
    per_joint = (d_a * s_mem[:, :, None, :] + d_b * s_det[None, None]) / 2.0
    pc = per_joint.mean(dim=-1) / cfg.epi_threshold  # (MH, C, D)

    n_members = torch.clamp(hyp_member.sum(dim=1), min=1)
    cost = torch.where(hyp_member[:, :, None], pc, 0.0).sum(dim=1) / n_members[:, None]
    veto = (hyp_member[:, :, None] & (pc > 1.0)).any(dim=1) & (det_bel > 0.5)[None, :]
    return cost, veto


def _init_targets(cfg: TrackerConfig, cams: CameraSet, state: TrackerState,
                  dets, unmatched, frame_id):
    C, J, MH, D = cfg.num_cameras, cfg.num_joints, cfg.max_hyp, cfg.max_dets
    dev = dets.device
    scores = dets[..., 2]
    # believe = mean of non-negative keypoint scores.
    nonneg = scores >= 0
    bel = torch.where(nonneg, scores, 0.0).sum(dim=-1) / torch.clamp(
        nonneg.sum(dim=-1), min=1)
    umask = unmatched & (bel > cfg.conf_threshold)

    hyp_pose = torch.zeros((MH, C, J, 3), dtype=torch.float32, device=dev)
    hyp_member = torch.zeros((MH, C), dtype=torch.bool, device=dev)
    hyp_count = torch.zeros((), dtype=torch.int64, device=dev)
    hrange = torch.arange(MH, device=dev)
    crange = torch.arange(C, device=dev)

    for c in range(C):
        # A camera with no qualified unmatched detections can neither merge
        # nor spawn: its LAP assigns nothing and every write below is void
        # (the JAX package skips it with a lax.cond).
        dets_c, mask_c, bel_c = dets[c], umask[c], bel[c]
        hyp_valid = hrange < hyp_count
        cost, veto = _hypothesis_costs(cfg, cams, hyp_pose, hyp_member, c,
                                       dets_c, bel_c)
        if cfg.tie_eps > 0.0:
            key = hyp_pose[..., 0] * 1e-3 + hyp_pose[..., 1] * 1.3e-3
            nm = torch.clamp(hyp_member.sum(dim=1), min=1)
            h_key = torch.where(hyp_member[:, :, None], key, 0.0).sum(
                dim=(1, 2)) / (nm * J)
            g_key = (dets_c[:, :, 0] * 1e-3 + dets_c[:, :, 1] * 1.3e-3).mean(dim=-1)
            cost_sel = cost + cfg.tie_eps * h_key[:, None] * g_key[None, :]
        else:
            cost_sel = cost
        col = masked_lap(cost_sel, hyp_valid, mask_c)  # (MH,) det idx or -1
        safe = col.clamp(min=0)
        got_veto = veto[hrange, safe]
        merged = (col >= 0) & ~got_veto
        mdet = dets_c[safe]  # (MH, J, 3)
        into = merged[:, None] & (crange == c)[None, :]  # (MH, C)
        hyp_pose = torch.where(into[:, :, None, None], mdet[:, None], hyp_pose)
        hyp_member = hyp_member | into
        # Spawn order: veto'd assignments in hypothesis order, then the
        # unassigned detections in index order.
        veto_spawn = (col >= 0) & got_veto
        unassigned = mask_c & ~_hit_mask(col, D)
        n1 = torch.cumsum(veto_spawn.to(torch.int64), 0)
        pos1 = torch.where(veto_spawn, hyp_count + n1 - 1, MH)
        n1_total = n1[-1]
        n2 = torch.cumsum(unassigned.to(torch.int64), 0)
        pos2 = torch.where(unassigned, hyp_count + n1_total + n2 - 1, MH)
        hyp_pose = _set_at(hyp_pose, pos1, c, mdet)
        hyp_member = _set_at(hyp_member, pos1, c, torch.ones_like(veto_spawn))
        hyp_pose = _set_at(hyp_pose, pos2, c, dets_c)
        hyp_member = _set_at(hyp_member, pos2, c, torch.ones_like(unassigned))
        hyp_count = torch.clamp(hyp_count + n1_total + n2[-1], max=MH)

    # Hypothesis building and slot allocation take effect only when there
    # are hypotheses (the JAX package's lax.cond, a select under vmap).
    built = _materialize_hypotheses(cfg, cams, state, hyp_pose, hyp_member,
                                    hyp_count, frame_id)
    some = hyp_count > 0
    return TrackerState(*(torch.where(some, new, old)
                          for new, old in zip(built, state)))


def _materialize_hypotheses(cfg, cams, state, hyp_pose, hyp_member, hyp_count,
                            frame_id):
    MH, T = cfg.max_hyp, cfg.max_tracks
    dev = hyp_pose.device
    n_members = hyp_member.sum(dim=1)
    D_t, _ = epipolar_distance_matrix(cams.F, hyp_pose, valid=hyp_member)
    aff = 1.0 - D_t / cfg.init_threshold
    keep = _greedy_init_keep(cfg, aff, hyp_member)
    n_views = keep.sum(dim=1).to(torch.int32)  # (MH, J)
    ok = (n_members >= 2) & (n_views >= 2).all(dim=1)
    pose3d, _ = triangulate_joints(cams.P, hyp_pose[..., :2],
                                   hyp_member.to(torch.float32), keep)
    ok = ok & (torch.arange(MH, device=dev) < hyp_count)

    if cfg.resurrect_window > 0:
        rescued, _, state = _rescue_stale_tracks(
            cfg, state, ok, pose3d, n_views, hyp_pose, hyp_member, frame_id)
        ok = ok & ~rescued

    # Allocate free track slots in hypothesis order.
    free = ~state.active
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1  # (T,)
    hyp_rank = torch.cumsum(ok.to(torch.int64), 0) - 1     # (MH,)
    tr = torch.arange(T, device=dev)
    slot_of_hyp = torch.where(
        free[None, :] & (free_rank[None, :] == hyp_rank[:, None]) & ok[:, None],
        tr[None, :], 0).sum(dim=1)
    alloc = ok & (hyp_rank < free.sum())
    slot = torch.where(alloc, slot_of_hyp, T)

    if cfg.resurrect_window > 0:
        res_id, grave_id = _match_graveyard(cfg, state, pose3d, alloc, frame_id)
        state = state._replace(grave_id=grave_id)
    else:
        res_id = torch.full((MH,), -1, dtype=torch.int32, device=dev)
    resur = res_id >= 0
    fresh = ok & ~resur
    fresh_rank = (torch.cumsum(fresh.to(torch.int32), 0) - 1).to(torch.int32)
    new_ids = torch.where(resur, res_id, state.next_id + fresh_rank)
    st = state
    hist_pose = _set_rows(st.hist_pose, slot, 0.0)
    hist_time = _set_rows(st.hist_time, slot, NEVER)
    first = torch.zeros(slot.shape[0], dtype=torch.long, device=dev)
    hp = torch.cat([hist_pose, hist_pose[:1]])
    ht = torch.cat([hist_time, hist_time[:1]])
    slot_l = slot.long()
    hp[slot_l, first] = pose3d
    ht[slot_l, first] = frame_id.to(torch.int32)
    return st._replace(
        active=_set_rows(st.active, slot, True),
        # Resurrected hypotheses continue a confirmed identity.
        confirmed=_set_rows(st.confirmed, slot, resur),
        track_id=_set_rows(st.track_id, slot, new_ids),
        hits=_set_rows(st.hits, slot, torch.where(resur, cfg.n_init, 1)),
        time_since_update=_set_rows(st.time_since_update, slot, 0),
        already_update=_set_rows(st.already_update, slot, False),
        pose2d=_set_rows(st.pose2d, slot, hyp_pose),
        pose2d_time=_set_rows(st.pose2d_time, slot,
                              torch.where(hyp_member, frame_id, NEVER)),
        hist_pose=hp[:T],
        hist_time=ht[:T],
        hist_count=_set_rows(st.hist_count, slot, 1),
        last_n_views=_set_rows(st.last_n_views, slot, n_views),
        velocity=_set_rows(st.velocity, slot, 0.0),
        next_id=st.next_id + fresh.sum().to(torch.int32),
    )


def _greedy_claim(dist):
    """Hypotheses in order each claim their nearest finite column, which is
    then consumed. Returns (hit (MH,) bool, column (MH,) int64)."""
    MH, N = dist.shape
    cols = torch.arange(N, device=dist.device)
    hits, picks = [], []
    for h in range(MH):
        t = torch.argmin(dist[h])
        hit = torch.isfinite(dist[h, t])
        hits.append(hit)
        picks.append(t)
        dist = torch.where(hit & (cols == t)[None, :], torch.inf, dist)
    return torch.stack(hits), torch.stack(picks)


def _rescue_stale_tracks(cfg, state, ok, pose3d, n_views, hyp_pose,
                         hyp_member, frame_id):
    """Greedy hypothesis -> active-confirmed-track matching (resurrection):
    a stale track (tsu >= 1) is re-seeded, a fresh one absorbs the member
    cameras' 2D poses. Returns (rescued (MH,), rescue_slot (MH,), state)."""
    T = cfg.max_tracks
    last_pose, last_time = _last_hist(state)
    eligible = state.active & state.confirmed
    dist = torch.linalg.vector_norm(
        pose3d[:, None] - last_pose[None], dim=-1).mean(dim=-1)  # (MH, T)
    gate = cfg.resurrect_dist + cfg.resurrect_speed * (
        frame_id - last_time).to(torch.float32)
    dist = torch.where(ok[:, None] & eligible[None, :] & (dist < gate[None, :]),
                       dist, torch.inf)
    rescued, rescue_slot = _greedy_claim(dist)

    stale_of_slot = state.time_since_update[rescue_slot] >= 1
    rslot = torch.where(rescued, rescue_slot, T)
    kslot = torch.where(rescued & stale_of_slot, rescue_slot, T)
    safe = rescue_slot.clamp(0, T - 1)
    new2d = torch.where(hyp_member[:, :, None, None], hyp_pose, state.pose2d[safe])
    new2dt = torch.where(hyp_member, frame_id, state.pose2d_time[safe])
    st = state._replace(
        pose2d=_set_rows(state.pose2d, rslot, new2d),
        pose2d_time=_set_rows(state.pose2d_time, rslot, new2dt),
        hits=_set_rows(state.hits, kslot, state.hits[safe] + 1),
        time_since_update=_set_rows(state.time_since_update, kslot, 0),
        already_update=_set_rows(state.already_update, kslot, True),
        hist_pose=_set_rows(state.hist_pose, kslot, 0.0),
        hist_time=_set_rows(state.hist_time, kslot, NEVER),
        hist_count=_set_rows(state.hist_count, kslot, 1),
        last_n_views=_set_rows(state.last_n_views, kslot, n_views),
        velocity=_set_rows(state.velocity, kslot, 0.0),
    )
    hp = torch.cat([st.hist_pose, st.hist_pose[:1]])
    ht = torch.cat([st.hist_time, st.hist_time[:1]])
    first = torch.zeros_like(kslot)
    hp[kslot, first] = pose3d
    ht[kslot, first] = frame_id.to(torch.int32)
    return rescued, rescue_slot, st._replace(hist_pose=hp[:T], hist_time=ht[:T])


def _match_graveyard(cfg, state, pose3d, alloc, frame_id):
    """Greedy hypothesis -> recently-deleted-track matching (resurrection).
    Returns (res_id (MH,) int32, -1 for no match; grave_id with the consumed
    entries cleared)."""
    G = cfg.max_tracks
    dist = torch.linalg.vector_norm(
        pose3d[:, None] - state.grave_pose[None], dim=-1).mean(dim=-1)  # (MH, G)
    gate = cfg.resurrect_dist + cfg.resurrect_speed * (
        frame_id - state.grave_time).to(torch.float32)
    g_valid = (state.grave_id >= 0) & (
        frame_id - state.grave_del <= cfg.resurrect_window)
    dist = torch.where(alloc[:, None] & g_valid[None, :] & (dist < gate[None, :]),
                       dist, torch.inf)
    hit, g = _greedy_claim(dist)
    res_id = torch.where(hit, state.grave_id[g], -1).to(torch.int32)
    consumed = _hit_mask(torch.where(hit, g, -1), G)
    return res_id, torch.where(consumed, -1, state.grave_id)


# --------------------------------------------------------------------------
# Frame step
# --------------------------------------------------------------------------

def tracker_step(cfg: TrackerConfig, cams: CameraSet, state: TrackerState,
                 dets, det_mask, frame_id):
    """One tracking frame.

    Args:
      cams: CameraSet with C == cfg.num_cameras, on the state's device.
      state: TrackerState.
      dets: (C, D, J, 3) detections, (x, y, score).
      det_mask: (C, D) bool validity.
      frame_id: int or 0-d integer tensor.

    Returns:
      (new_state, FrameOutput)
    """
    dev = state.active.device
    dets = torch.as_tensor(dets, device=dev).to(torch.float32)
    det_mask = torch.as_tensor(det_mask, device=dev).to(torch.bool)
    if torch.is_tensor(frame_id):
        frame_id = frame_id.to(device=dev, dtype=torch.int32)
    else:  # a fill, not a host copy that would wait for the stream
        frame_id = torch.full((), int(frame_id), dtype=torch.int32, device=dev)
    # add_age
    state = state._replace(
        already_update=torch.zeros_like(state.already_update),
        time_since_update=torch.where(
            state.active, state.time_since_update + 1, state.time_since_update),
    )
    matched, match_col, unmatched = _associate(cfg, cams, state, dets,
                                               det_mask, frame_id)
    state = _apply_matches(state, dets, matched, match_col, frame_id)
    state = _update_tracks(cfg, cams, state, frame_id)
    state = _init_targets(cfg, cams, state, dets, unmatched, frame_id)

    pose3d, _ = _last_hist(state)
    out = FrameOutput(
        valid=state.active & state.confirmed & (state.time_since_update == 0),
        track_id=state.track_id,
        pose3d=pose3d,
        n_views=state.last_n_views,
        pose2d=state.pose2d,
        pose2d_now=state.pose2d_time == frame_id,
    )
    return state, out


def stack_outputs(outs) -> FrameOutput:
    """A list of per-frame FrameOutputs -> one stacked over frames."""
    return FrameOutput(*(torch.stack(field) for field in zip(*outs)))


def _captured(cfg, cams, state, dets, det_mask, frame_id):
    """The process's captured `tracker_step` for `cfg` at these inputs'
    device, shapes and dtypes (`runtime.graphs.captured_step`)."""
    return captured_step(("tracker_step", cfg), partial(tracker_step, cfg), cams, state,
                         dets, det_mask, frame_id)


def make_step_fn(cfg: TrackerConfig):
    """The step over a static config, as the JAX package's jitted one:
    fn(cams, state, dets, det_mask, frame_id) -> (state, FrameOutput).

    Each input signature (device, shapes, dtypes) is captured once per
    process as a CUDA graph of `tracker_step` and replayed on every call
    (`runtime.graphs.CapturedStep.step`; on the CPU the same buffers run
    the eager step). What it returns is the caller's, and `frame_id` (an
    int or an integer tensor) reaches the program through a device buffer."""
    def step(cams, state, dets, det_mask, frame_id):
        return _captured(cfg, cams, state, dets, det_mask, frame_id).step(
            cams, state, dets, det_mask, frame_id)

    return step


def track_clip(cfg: TrackerConfig, cams: CameraSet, state: TrackerState,
               dets, det_mask, frame_ids):
    """The tracker over a buffered clip: `make_step_fn`'s program replayed
    frame by frame, each frame's outputs copied into one (F, ...) buffer.

    Args:
      dets: (F, C, D, J, 3); det_mask: (F, C, D); frame_ids: (F,).
    Returns:
      (final_state, FrameOutput stacked over F).
    """
    dets, det_mask = torch.as_tensor(dets), torch.as_tensor(det_mask)
    frame_ids = torch.as_tensor(frame_ids)
    with timing.clip():
        return _captured(cfg, cams, state, dets[0], det_mask[0], frame_ids[0]).clip(
            cams, state, dets, det_mask, frame_ids, span="stage_b.clip")
