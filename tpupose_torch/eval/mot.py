"""Multi-object tracking metrics: MOTA, MOTP, ID switches, IDF1.

Counterpart of `tpupose/eval/mot.py`: CLEAR-MOT and IDF1 for 3D pose
tracks. Per-frame matching keeps persistent matches while they stay within
the distance threshold and matches the rest by Hungarian assignment on 3D
distance; IDF1 solves the global identity assignment maximizing total
overlap.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _pose_dist(a, b):
    """Mean per-joint distance between two (J, 3) poses."""
    return float(np.mean(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)))


def evaluate_mot(gt_frames, pred_frames, dist_threshold=0.5):
    """Compute CLEAR-MOT + IDF1 over a sequence.

    Args:
      gt_frames: list over frames of dict gt_id -> (J, 3) pose.
      pred_frames: list over frames of dict pred_id -> (J, 3) pose.
      dist_threshold: max mean-joint distance (meters) for a valid match.

    Returns:
      dict with mota, motp, idf1, id_switches, false_positives, misses,
      num_gt, num_matches.
    """
    if len(gt_frames) != len(pred_frames):
        raise ValueError(f"{len(gt_frames)} GT frames but "
                         f"{len(pred_frames)} predicted frames")
    num_gt = 0
    fp = 0
    fn = 0
    idsw = 0
    dist_sum = 0.0
    matches_total = 0
    last_match = {}  # gt_id -> pred_id

    # Accumulators for IDF1.
    overlap = {}  # (gt_id, pred_id) -> co-detection count
    gt_counts = {}
    pred_counts = {}

    for gts, preds in zip(gt_frames, pred_frames):
        gt_ids = list(gts.keys())
        pred_ids = list(preds.keys())
        num_gt += len(gt_ids)
        for g in gt_ids:
            gt_counts[g] = gt_counts.get(g, 0) + 1
        for p in pred_ids:
            pred_counts[p] = pred_counts.get(p, 0) + 1

        # 1. keep persistent matches if still close.
        matched_g, matched_p = set(), set()
        frame_match = {}
        for g in gt_ids:
            p = last_match.get(g)
            if p is not None and p in preds:
                d = _pose_dist(gts[g], preds[p])
                if d <= dist_threshold:
                    frame_match[g] = (p, d)
                    matched_g.add(g)
                    matched_p.add(p)

        # 2. Hungarian on the rest.
        rest_g = [g for g in gt_ids if g not in matched_g]
        rest_p = [p for p in pred_ids if p not in matched_p]
        if rest_g and rest_p:
            C = np.full((len(rest_g), len(rest_p)), 1e6)
            for i, g in enumerate(rest_g):
                for j, p in enumerate(rest_p):
                    d = _pose_dist(gts[g], preds[p])
                    if d <= dist_threshold:
                        C[i, j] = d
            rows, cols = linear_sum_assignment(C)
            for i, j in zip(rows, cols):
                if C[i, j] <= dist_threshold:
                    g, p = rest_g[i], rest_p[j]
                    frame_match[g] = (p, C[i, j])
                    matched_g.add(g)
                    matched_p.add(p)

        for g, (p, d) in frame_match.items():
            if g in last_match and last_match[g] != p:
                idsw += 1
            last_match[g] = p
            dist_sum += d
            matches_total += 1
            overlap[(g, p)] = overlap.get((g, p), 0) + 1

        fn += len(gt_ids) - len(frame_match)
        fp += len(pred_ids) - len(matched_p)

    mota = 1.0 - (fn + fp + idsw) / num_gt if num_gt else np.nan
    motp = dist_sum / matches_total if matches_total else np.nan

    # IDF1: global bipartite assignment gt_id <-> pred_id maximizing overlap.
    g_list = sorted(gt_counts)
    p_list = sorted(pred_counts)
    idtp = 0
    if g_list and p_list:
        M = np.zeros((len(g_list), len(p_list)))
        for (g, p), cnt in overlap.items():
            M[g_list.index(g), p_list.index(p)] = cnt
        rows, cols = linear_sum_assignment(-M)
        idtp = int(M[rows, cols].sum())
    total_gt_dets = sum(gt_counts.values())
    total_pred_dets = sum(pred_counts.values())
    idf1 = (
        2 * idtp / (total_gt_dets + total_pred_dets)
        if total_gt_dets + total_pred_dets
        else np.nan
    )

    return {
        "mota": mota,
        "motp": motp,
        "idf1": idf1,
        "id_switches": idsw,
        "false_positives": fp,
        "misses": fn,
        "num_gt": num_gt,
        "num_matches": matches_total,
    }
