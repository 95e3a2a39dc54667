"""The tracker's reference: a frozen copy of the port's numpy f64 oracle
(`tracking/oracle.py` at the commit that added this benchmark), the
readable encoding of the iterative multi-view tracker that the port's
tracker is specified by. It imports nothing of the program; the rig's
fundamental matrices, ray matrices and centres are worked out here from
P, K and RT (`rig`).

Algorithm per frame (reference call stack SURVEY.md §3.3):
  1. age all tracks; snapshot each track's last 3D pose + staleness dt.
  2. per camera: reproject track poses; per-joint scores
     s = 1 - ||reproj - det|| / (alpha2d * dt); pairs with more than
     `joint_gate` positive joints get affinity
     mean(positive s) * exp(-lambda_a * dt); Hungarian (maximize); matches
     with affinity > 0 update that track's per-camera 2D store; the rest
     become this camera's unmatched detections.
  3. per track: collect per-camera 2D poses with staleness <= 3 (need >= 2);
     per-joint cross-view epipolar consistency scores
     1 - d/joint_threshold; greedy removal of inconsistent views (drop the
     view whose back-projection ray is farther from the motion-predicted 3D
     joint); fail if more than J/3 joints keep < 2 views; time-weighted DLT
     triangulation with per-joint view masks (1-view joints fall back to the
     motion prediction); Gaussian temporal smoothing; constant-velocity
     update (mean of up to 5 most recent history diffs); state machine
     Tentative(n_init) -> Confirmed -> Deleted(max_age).
  4. init new targets: confidence-filter unmatched detections; greedy
     cross-camera hypothesis building with Hungarian + veto
     (cost = confidence-weighted epipolar distance / epi_threshold; veto if
     any member cost > 1 and detection belief > 0.5); hypotheses with >= 2
     views triangulate (greedy 'init' filter: drop the view with the smaller
     affinity row-sum; fail if ANY joint keeps < 2 views) and become tracks.
  5. prune deleted tracks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.optimize import linear_sum_assignment

#: Floor of the triangulation's time weights, relative to the largest.
TIME_WEIGHT_REL_FLOOR = 1e-2

TENTATIVE, CONFIRMED, DELETED = 1, 2, 3


@dataclasses.dataclass
class TrackerParams:
    """Hyper-parameters (YAML PERSON_MATCHERS.ITERATIVE block, SURVEY §2.1)."""

    conf_threshold: float = 0.4
    epi_threshold: float = 25.0
    init_threshold: float = 15.0
    joint_threshold: float = 15.0
    num_joints: int = 17
    n_init: int = 3
    max_age: int = 10
    alpha2d: float = 30.0
    lambda_a: float = 3.0
    lambda_t: float = 5.0
    sigma: float = 0.6
    arm_sigma: float = 0.8
    #: per-pair joint-count gate in association; the reference hardcodes 10
    #: (`IterativeTracker.py:145`, comment: Shelf 10 / Campus 14).
    joint_gate: int = 10
    #: staleness window for a camera's 2D pose to join the 3D update
    #: (`IterativeTracker.py:317`).
    update_window: int = 3
    arm_joints: tuple = (9, 10)
    #: Track resurrection (new, no reference counterpart): when > 0, a new
    #: hypothesis spawning near a recently-deleted confirmed track's last
    #: pose reuses that track's id + confirmed status, for up to
    #: `resurrect_window` frames after the deletion; a hypothesis spawning
    #: near a still-ACTIVE confirmed track is claimed by it instead of
    #: minting a duplicate id (full kinematic re-seed if the track is stale,
    #: 2D-store merge if it updated this frame). The gate is mean joint
    #: distance < resurrect_dist + resurrect_speed * (frames since the
    #: track's last update) — a motion budget for the occluded person.
    #: 0 = off.
    resurrect_window: int = 0
    resurrect_dist: float = 0.5
    resurrect_speed: float = 0.06
    #: Deterministic near-tie association bias (mirror of
    #: TrackerConfig.tie_eps).
    tie_eps: float = 3e-3
    #: Graveyard capacity — mirrors the tracker's fixed ring of
    #: `max_tracks` entries (tracker.py `_bury_tracks`): a new burial evicts
    #: the entry buried `max_tracks` burials ago, consumed or not.
    max_tracks: int = 16


def believe(pose):
    """Mean keypoint confidence (`src/utils/calculate.py:8-14`)."""
    s = pose[:, 2]
    return float(np.mean(s[s >= 0])) if np.any(s >= 0) else np.nan


class _Cameras:
    """Thin numpy camera rig (P, F, rk_inv, centers)."""

    def __init__(self, P, F, rk_inv, center):
        self.P = np.asarray(P, np.float64)
        self.F = np.asarray(F, np.float64)
        self.rk_inv = np.asarray(rk_inv, np.float64)
        self.center = np.asarray(center, np.float64)
        self.num = len(self.P)

    def project_cam(self, cid, pts3d):
        """(..., 3) -> (..., 2) as (x, y) through camera `cid`."""
        hom = np.concatenate([pts3d, np.ones_like(pts3d[..., :1])], axis=-1)
        proj = np.einsum("ij,...j->...i", self.P[cid], hom)
        z = np.where(proj[..., 2:3] == 0.0, 1e-5, proj[..., 2:3])
        return proj[..., :2] / z


def _point_line_dist(pts_xy, lines):
    hom = np.concatenate([pts_xy[..., :2], np.ones_like(pts_xy[..., :1])], -1)
    n = np.sqrt(np.sum(lines[..., :2] ** 2, -1))
    n = np.where(n == 0.0, 1.0, n)
    return np.abs(np.sum(hom * lines, -1)) / n


def epipolar_pair(F_ab, pose_a, pose_b):
    """(d_a, d_b): distances of a's (b's) points to the other's epilines."""
    hom_a = np.concatenate([pose_a[:, :2], np.ones((len(pose_a), 1))], 1)
    hom_b = np.concatenate([pose_b[:, :2], np.ones((len(pose_b), 1))], 1)
    d_a = _point_line_dist(pose_a[:, :2], hom_b @ F_ab.T)
    d_b = _point_line_dist(pose_b[:, :2], hom_a @ F_ab)
    return d_a, d_b


def epipolar_distance_tensor(F, cam_ids, poses):
    """(V, V, J) symmetrized per-joint distances (matching.py:115-151)."""
    V, J = len(poses), poses.shape[1]
    D = np.zeros((V, V, J))
    for a in range(V):
        for b in range(V):
            if cam_ids[a] == cam_ids[b]:
                continue
            _, d_b = epipolar_pair(F[cam_ids[a], cam_ids[b]], poses[a], poses[b])
            D[a, b] = d_b
    return (D + np.transpose(D, (1, 0, 2))) / 2


def back_project_ray(rk_inv, point_xy):
    d = rk_inv @ np.array([point_xy[0], point_xy[1], 1.0])
    return d / np.linalg.norm(d)


def ray_point_dist(center, direction, point3d):
    cross = np.cross(direction, center - point3d)
    return np.linalg.norm(cross) / np.linalg.norm(direction)


def greedy_view_filter_update(cams: _Cameras, cam_ids, joint_xy, affinity,
                              next_point):
    """Per-joint greedy conflict resolution, mode='update'.

    matching.py:243-277: iterate upper-triangle pairs (row-major) with
    affinity < 0; drop the view whose back-projected ray through this joint's
    pixel is farther from the motion-predicted 3D point.
    Returns keep mask (V,).
    """
    V = len(cam_ids)
    keep = np.ones(V, bool)
    dist_cache = np.zeros(V)
    for r in range(V):
        for c in range(r, V):
            if affinity[r, c] >= 0 or not (keep[r] and keep[c]):
                continue
            for v in (r, c):
                if dist_cache[v] == 0:
                    ray = back_project_ray(cams.rk_inv[cam_ids[v]], joint_xy[v])
                    dist_cache[v] = ray_point_dist(
                        cams.center[cam_ids[v]], ray, next_point
                    )
            if dist_cache[r] > dist_cache[c]:
                keep[r] = False
            else:
                keep[c] = False
    return keep


def greedy_view_filter_init(affinity):
    """mode='init': drop the view with the smaller affinity row-sum
    (matching.py:286-294). Row sums are over the full matrix, fixed upfront.
    """
    V = affinity.shape[0]
    keep = np.ones(V, bool)
    row_sums = affinity.sum(axis=1)
    for r in range(V):
        for c in range(r, V):
            if affinity[r, c] >= 0 or not (keep[r] and keep[c]):
                continue
            if row_sums[r] > row_sums[c]:
                keep[c] = False
            else:
                keep[r] = False
    return keep


def triangulate(cams: _Cameras, cam_ids, Ts, poses, lambda_t, keep_mask,
                fallback=None):
    """Time-weighted DLT with per-joint view masks (construction.py:89-114)."""
    V, J = poses.shape[:2]
    pose3d = np.zeros((J, 3))
    n_views = keep_mask.sum(axis=0)
    for j in range(J):
        kept = np.where(keep_mask[:, j])[0]
        if len(kept) < 2:
            pose3d[j] = fallback[j] if fallback is not None else 0.0
            continue
        # Relative weight floor, identical to the tracker's kernel (see
        # `TIME_WEIGHT_REL_FLOOR`): the spec
        # mirrors the floored weighting so tracker and oracle stay in
        # lockstep (the floor moves the optimum by only O(floor^2)).
        ws = np.exp(-lambda_t * np.asarray(Ts, np.float64)[kept])
        ws = np.maximum(ws, ws.max() * TIME_WEIGHT_REL_FLOOR)
        rows = []
        for v, w in zip(kept, ws):
            P = cams.P[cam_ids[v]]
            x, y = poses[v, j, 0], poses[v, j, 1]
            for r in (x * P[2] - P[0], y * P[2] - P[1]):
                rows.append(w * r / np.linalg.norm(r))
        A = np.stack(rows)
        _, _, VT = np.linalg.svd(A)
        X = VT[-1]
        pose3d[j] = X[:3] / X[3]
    return pose3d, n_views


class OracleTrack:
    def __init__(self, track_id, time, cam_ids, poses2d, pose3d, n_views, p: TrackerParams):
        self.p = p
        self.track_id = track_id
        self.hits = 1
        self.age = 1
        self.time_since_update = 0
        self.already_update = False
        self.state = TENTATIVE
        # Sticky confirmation flag: burial eligibility is the tracker's
        # `deleted & confirmed`, not the hits>=n_init proxy (they differ for
        # n_init=1, where a just-born tentative track has hits=1 but is not
        # yet confirmed when deleted).
        self.was_confirmed = False
        # per-camera latest 2D pose: cid -> (time, pose (J,3))
        self.poses2d = {int(c): (time, np.array(q)) for c, q in zip(cam_ids, poses2d)}
        self.history = [(time, np.array(pose3d, np.float64))]  # chronological
        self.last_n_views = np.array(n_views)
        self.velocity = np.zeros((p.num_joints, 3))

    # -- state machine ------------------------------------------------------
    def add_age(self):
        self.already_update = False
        self.age += 1
        self.time_since_update += 1

    def mark_missed(self):
        if self.state == TENTATIVE and not self.already_update:
            self.state = DELETED
        elif self.time_since_update >= self.p.max_age:
            self.state = DELETED

    # -- 3D update ----------------------------------------------------------
    def update(self, time, cams: _Cameras):
        if self._update_3dpose(time, cams):
            self._update_motion()
            self.hits += 1
            self.time_since_update = 0
            if self.state == TENTATIVE and self.hits >= self.p.n_init:
                self.state = CONFIRMED
                self.was_confirmed = True
        else:
            self.mark_missed()

    def _update_3dpose(self, time, cams):
        if not self.already_update:
            return False
        cam_ids, Ts, poses = [], [], []
        for cid, (t2d, pose) in self.poses2d.items():
            dt = time - t2d
            if dt <= self.p.update_window:
                cam_ids.append(cid)
                Ts.append(dt)
                poses.append(pose)
        if len(cam_ids) < 2:
            return False
        poses = np.stack(poses)
        pose3d, n_views, ok = self._build_pose(time, cams, cam_ids, Ts, poses)
        if not ok:
            return False
        pose3d = self._smooth(pose3d)
        self.history.append((time, pose3d))
        self.last_n_views = n_views
        if time - self.history[0][0] > self.p.max_age:
            del self.history[0]
        return True

    def _build_pose(self, time, cams, cam_ids, Ts, poses):
        last_time, last_pose = self.history[-1]
        next_pose = last_pose + self.velocity * (time - last_time)
        D = epipolar_distance_tensor(cams.F, cam_ids, poses)
        affinity = 1.0 - D / self.p.joint_threshold  # (V, V, J)
        V = len(cam_ids)
        keep = np.ones((V, self.p.num_joints), bool)
        fail = 0
        for j in range(self.p.num_joints):
            keep[:, j] = greedy_view_filter_update(
                cams, cam_ids, poses[:, j, :2], affinity[:, :, j], next_pose[j]
            )
            if keep[:, j].sum() < 2:
                fail += 1
        pose3d, n_views = triangulate(
            cams, cam_ids, Ts, poses, self.p.lambda_t, keep, fallback=next_pose
        )
        return pose3d, n_views, fail <= self.p.num_joints / 3

    def _smooth(self, pose3d):
        hist = np.stack([h for _, h in self.history] + [pose3d])
        body = gaussian_filter1d(hist, self.p.sigma, axis=0, mode="reflect")[-1]
        arms = gaussian_filter1d(hist, self.p.arm_sigma, axis=0, mode="reflect")[-1]
        out = body
        out[list(self.p.arm_joints)] = arms[list(self.p.arm_joints)]
        return out

    def _update_motion(self):
        if len(self.history) < 2:
            return
        diffs = []
        for idx in range(len(self.history) - 1, 0, -1):
            diffs.append(self.history[idx][1] - self.history[idx - 1][1])
            if len(diffs) > 4:
                break
        self.velocity = np.mean(diffs, axis=0)


class _Hypothesis:
    def __init__(self, cam_id, pose, epi_threshold):
        self.cam_ids = [cam_id]
        self.poses = [np.array(pose)]
        self.threshold = epi_threshold

    def cost(self, cams: _Cameras, o_cam, o_pose):
        """Confidence-weighted epipolar cost + veto (hypothesis.py:53-68)."""
        veto = False
        total = 0.0
        for cid, pose in zip(self.cam_ids, self.poses):
            d_a, d_b = epipolar_pair(cams.F[cid, o_cam], pose, o_pose)
            per_joint = (d_a * pose[:, 2] + d_b * o_pose[:, 2]) / 2
            p_cost = float(np.mean(per_joint)) / self.threshold
            total += p_cost
            if p_cost > 1 and believe(o_pose) > 0.5:
                veto = True
        return total / len(self.poses), veto

    def merge(self, cam_id, pose):
        self.cam_ids.append(cam_id)
        self.poses.append(np.array(pose))


class OracleTracker:
    """Dynamic-Python tracker; specification for `tracking.tracker`."""

    def __init__(self, cams: Optional[_Cameras], params: TrackerParams):
        self.cams = cams
        self.p = params
        self.tracks: list[OracleTrack] = []
        self.next_id = 0
        self.unmatched: dict[int, np.ndarray] = {}
        # Recently-deleted confirmed tracks eligible for resurrection:
        # dicts of id / pose / time (last-update frame) / del (frame) / seq
        # (burial counter). Capped at p.max_tracks entries, mirroring the
        # tracker's fixed graveyard ring: burial #n evicts burial
        # #(n - max_tracks), consumed or not.
        self.graveyard: list[dict] = []
        self._burials = 0

    @staticmethod
    def make_cameras(P, F, rk_inv, center) -> _Cameras:
        return _Cameras(P, F, rk_inv, center)

    def step(self, frame_id, detections_per_cam):
        """One frame. detections_per_cam: list over cameras of (M_c, J, 3)
        arrays with (x, y, score)."""
        p = self.p
        tracks_pose, tracks_dt = [], []
        for tr in self.tracks:
            tr.add_age()
            tracks_pose.append(tr.history[-1][1])
            tracks_dt.append(frame_id - tr.history[-1][0])

        self.unmatched = {}
        for cid, dets in enumerate(detections_per_cam):
            dets = np.asarray(dets, np.float64).reshape(-1, p.num_joints, 3)
            n, m = len(self.tracks), len(dets)
            if n > 0 and m > 0:
                reproj = np.stack(
                    [self.cams.project_cam(cid, tp) for tp in tracks_pose]
                )  # (n, J, 2)
                d = np.linalg.norm(
                    reproj[:, None, :, :] - dets[None, :, :, :2], axis=-1
                )  # (n, m, J)
                dt = np.asarray(tracks_dt, np.float64)[:, None, None]
                scores = 1.0 - d / (p.alpha2d * dt)
                pos = scores > 0
                n_pos = pos.sum(axis=2)
                with np.errstate(invalid="ignore"):
                    aff = np.where(pos, scores, 0.0).sum(axis=2) / n_pos
                aff[n_pos <= p.joint_gate] = 0.0
                aff = aff / np.exp(p.lambda_a * dt[:, :, 0])
                aff[np.isnan(aff)] = 0.0
                if p.tie_eps > 0.0:
                    # deterministic near-tie resolution, identical to the
                    # tracker (_associate): golden-ratio hash of the track id
                    # x smooth position key of the detection; acceptance
                    # below still uses the unbiased affinity
                    fid = np.array(
                        [(tr.track_id * 0.6180339887498949) % 1.0
                         for tr in self.tracks]
                    )
                    g = (dets[:, :, 0].mean(axis=1) * 1e-3
                         + dets[:, :, 1].mean(axis=1) * 1.3e-3)
                    aff_sel = np.where(
                        aff > 0, aff + p.tie_eps * fid[:, None] * g[None, :],
                        aff,
                    )
                else:
                    aff_sel = aff
                rows, cols = linear_sum_assignment(-aff_sel)
                handled = set()
                for ti, pi in zip(rows, cols):
                    if aff[ti, pi] > 0:
                        tr = self.tracks[ti]
                        tr.already_update = True
                        tr.poses2d[cid] = (frame_id, dets[pi])
                        handled.add(pi)
                rest = [i for i in range(m) if i not in handled]
                self.unmatched[cid] = dets[rest]
            else:
                self.unmatched[cid] = dets

        for tr in self.tracks:
            tr.update(frame_id, self.cams)

        if p.resurrect_window > 0:
            for tr in self.tracks:
                # `deleted & confirmed` — same burial condition as the tracker.
                if tr.state == DELETED and tr.was_confirmed:
                    t2d, pose = tr.history[-1]
                    self.graveyard.append({
                        "id": tr.track_id,
                        "pose": np.array(pose),
                        "time": t2d,
                        "del": frame_id,
                        "seq": self._burials,
                    })
                    self._burials += 1
            # Ring-capacity eviction (burial #n overwrites #(n - max_tracks)).
            self.graveyard = [
                g for g in self.graveyard
                if g["seq"] >= self._burials - p.max_tracks
            ]

        self._init_targets(frame_id)
        self.tracks = [t for t in self.tracks if t.state != DELETED]

    def _init_targets(self, frame_id):
        """Greedy cross-camera hypothesis building (IterativeTracker.py:52-113)."""
        p = self.p
        if len(self.unmatched) < 2:
            return
        filtered = {
            cid: np.array([d for d in dets if believe(d) > p.conf_threshold])
            for cid, dets in self.unmatched.items()
        }
        H: list[_Hypothesis] = []
        for idx, (cid, dets) in enumerate(filtered.items()):
            if idx == 0:
                H = [_Hypothesis(cid, d, p.epi_threshold) for d in dets]
                continue
            if len(H) == 0 or len(dets) == 0:
                for d in dets:
                    H.append(_Hypothesis(cid, d, p.epi_threshold))
                continue
            C = np.zeros((len(H), len(dets)))
            veto = np.zeros_like(C, bool)
            for hi, hyp in enumerate(H):
                for di, det in enumerate(dets):
                    C[hi, di], veto[hi, di] = hyp.cost(self.cams, cid, det)
            if p.tie_eps > 0.0:
                # deterministic near-tie resolution, identical to the tracker
                # (_init_targets): geometric position keys; veto below
                # still reads the unbiased costs
                h_key = np.array([
                    np.mean([(po[:, 0] * 1e-3 + po[:, 1] * 1.3e-3).mean()
                             for po in hyp.poses])
                    for hyp in H
                ])
                g_key = np.array([
                    (d[:, 0] * 1e-3 + d[:, 1] * 1.3e-3).mean() for d in dets
                ])
                C_sel = C + p.tie_eps * h_key[:, None] * g_key[None, :]
            else:
                C_sel = C
            rows, cols = linear_sum_assignment(C_sel)
            handled = set()
            for hi, di in zip(rows, cols):
                handled.add(di)
                if veto[hi, di]:
                    H.append(_Hypothesis(cid, dets[di], p.epi_threshold))
                else:
                    H[hi].merge(cid, dets[di])
            for di, det in enumerate(dets):
                if di not in handled:
                    H.append(_Hypothesis(cid, det, p.epi_threshold))

        # Rescue candidates: tracks present after the 3D-update phase (the
        # tracker snapshots state before slot allocation), each claimable once
        # per frame (the tracker consumes the track's column in its greedy
        # hypothesis->track matching).
        live = list(self.tracks)
        claimed: set = set()
        for hyp in H:
            if len(hyp.poses) < 2:
                continue
            ok, pose3d, n_views = self._init_triangulate(hyp)
            if not ok:
                continue
            if self._rescue_stale(frame_id, pose3d, n_views, hyp, live,
                                  claimed):
                continue
            revived = self._match_graveyard(frame_id, pose3d)
            if revived is not None:
                tr = OracleTrack(
                    revived, frame_id, hyp.cam_ids, hyp.poses, pose3d,
                    n_views, p,
                )
                tr.state = CONFIRMED
                tr.was_confirmed = True
                tr.hits = p.n_init
            else:
                tr = OracleTrack(
                    self.next_id, frame_id, hyp.cam_ids, hyp.poses, pose3d,
                    n_views, p,
                )
                self.next_id += 1
            self.tracks.append(tr)

    def _rescue_stale(self, frame_id, pose3d, n_views, hyp, live, claimed):
        """A hypothesis landing near an ACTIVE confirmed track is claimed by
        that track instead of minting a duplicate id. Stale tracks (missed
        this frame's association) get a full kinematic re-seed — identity
        (id, confirmed, hits) continues, kinematics restart like a birth.
        Fresh tracks (updated this frame; the dominant churn pattern: a
        duplicate forms from the cameras whose association broke while the
        rest kept matching) get a soft absorb: only the hypothesis member
        cameras' 2D poses are merged, so the next update pulls the drifted
        3D pose back. Returns True when a track claimed the hypothesis."""
        p = self.p
        if p.resurrect_window <= 0:
            return False
        best, best_d = None, np.inf
        for tr in live:
            if tr.state != CONFIRMED or id(tr) in claimed:
                continue
            lt, lp = tr.history[-1]
            d = float(np.mean(np.linalg.norm(pose3d - lp, axis=-1)))
            gate = p.resurrect_dist + p.resurrect_speed * (frame_id - lt)
            if d < gate and d < best_d:
                best, best_d = tr, d
        if best is None:
            return False
        tr = best
        claimed.add(id(tr))
        for cid, pose in zip(hyp.cam_ids, hyp.poses):
            tr.poses2d[int(cid)] = (frame_id, np.array(pose))
        if tr.time_since_update >= 1:
            tr.history = [(frame_id, np.array(pose3d, np.float64))]
            tr.velocity = np.zeros((p.num_joints, 3))
            tr.hits += 1
            tr.time_since_update = 0
            tr.already_update = True
            tr.last_n_views = np.array(n_views)
        return True

    def _match_graveyard(self, frame_id, pose3d):
        """Nearest unexpired graveyard entry whose last pose is inside its
        motion-budget gate (resurrect_dist + resurrect_speed * frames since
        its last update); consumed on match. Returns the revived id or
        None."""
        p = self.p
        if p.resurrect_window <= 0:
            return None
        best, best_d = None, np.inf
        for gi, g in enumerate(self.graveyard):
            if frame_id - g["del"] > p.resurrect_window:
                continue
            d = float(np.mean(np.linalg.norm(pose3d - g["pose"], axis=-1)))
            gate = p.resurrect_dist + p.resurrect_speed * (
                frame_id - g["time"]
            )
            if d < gate and d < best_d:
                best, best_d = gi, d
        if best is not None:
            return self.graveyard.pop(best)["id"]
        return None

    def _init_triangulate(self, hyp: _Hypothesis):
        """hypothesis.get_3dpose_jf (hypothesis.py:23-44)."""
        p = self.p
        poses = np.stack(hyp.poses)
        D = epipolar_distance_tensor(self.cams.F, hyp.cam_ids, poses)
        affinity = 1.0 - D / p.init_threshold
        V = len(hyp.cam_ids)
        keep = np.ones((V, p.num_joints), bool)
        for j in range(p.num_joints):
            keep[:, j] = greedy_view_filter_init(affinity[:, :, j])
            if keep[:, j].sum() < 2:
                return False, None, None
        pose3d, n_views = triangulate(
            self.cams, hyp.cam_ids, np.zeros(V), poses, p.lambda_t, keep
        )
        return True, pose3d, n_views

    # -- outputs -------------------------------------------------------------
    def outputs(self, frame_id):
        """Confirmed, just-updated tracks (ivclabpose.py:259-287)."""
        out = []
        for tr in self.tracks:
            if tr.time_since_update > 0 or tr.state != CONFIRMED:
                continue
            cams_2d = {
                cid: pose
                for cid, (t, pose) in tr.poses2d.items()
                if t == frame_id
            }
            out.append(
                {
                    "id": tr.track_id,
                    "pose3d": tr.history[-1][1].copy(),
                    "n_views": tr.last_n_views.copy(),
                    "poses2d": cams_2d,
                }
            )
        return out


def _fundamental(K0, R0, T0, K1, R1, T1):
    """F with x_0^T F x_1 = 0 between two calibrated views."""
    R_rel = R0 @ R1.T
    t = K1 @ (R1 @ (R0.T @ (T0 - R_rel @ T1)))
    skew = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]])
    return ((np.linalg.inv(K0).T @ R_rel) @ K1.T) @ skew


def rig(P, K, RT) -> _Cameras:
    """The oracle's cameras from (C, 3, 4) P, (C, 3, 3) K, (C, 3, 4) RT, in
    f64: all-pairs fundamental matrices (an all-zero one nudged by 1e-12),
    R^-1 K^-1 and the centres."""
    P, K, RT = (np.asarray(a, np.float64) for a in (P, K, RT))
    R, t = RT[:, :, :3], RT[:, :, 3]
    R_inv = np.linalg.inv(R)
    C = len(P)
    F = np.zeros((C, C, 3, 3))
    for a in range(C):
        for b in range(C):
            f = _fundamental(K[a], R[a], t[a], K[b], R[b], t[b])
            F[a, b] = f + 1e-12 if not np.abs(f).sum() else f
    return _Cameras(P, F, R_inv @ np.linalg.inv(K), -np.einsum("cij,cj->ci", R_inv, t))
