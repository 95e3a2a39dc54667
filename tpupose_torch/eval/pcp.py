"""PCP (Percentage of Correct Parts) scoring for Campus / Shelf.

Counterpart of `tpupose/eval/pcp.py`, a formula port of
`Evaluate3DPose_PCP` (`src/evalmodel.py:120-206`): a bone is correct iff
the mean of its two endpoint errors is <= alpha * GT bone length (alpha =
0.5); 9 Shelf bones plus a synthesized hip->head bone; results aggregated
per bone group and per actor, printed in the same table layout.
"""
from __future__ import annotations

import os.path as osp
import pickle
from collections import OrderedDict

import numpy as np

from tpupose_torch.eval.transforms import coco2shelf3d, nan_masked_sqdist
from tpupose_torch.utils.tables import Table

#: Shelf-14 bones scored directly (`src/evalmodel.py:160`).
BONES = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [9, 10], [10, 11], [12, 13]]

BONE_GROUPS = OrderedDict(
    [
        ("Head", np.array([8])),
        ("Torso", np.array([9])),
        ("Upper arms", np.array([5, 6])),
        ("Lower arms", np.array([4, 7])),
        ("Upper legs", np.array([1, 2])),
        ("Lower legs", np.array([0, 3])),
    ]
)


def bone_is_right(model_start, model_end, gt_start, gt_end, alpha=0.5):
    bone_len = np.linalg.norm(gt_end - gt_start)
    err = (
        np.linalg.norm(gt_start - model_start) + np.linalg.norm(gt_end - model_end)
    ) / 2
    return err <= alpha * bone_len


def evaluate_pcp(eval_ranges, multi_poses3d, actors_gt, num_report_actors=3):
    """Score predictions against per-actor GT.

    Args:
      eval_ranges: list of [start, end) frame ranges.
      multi_poses3d: dict frame_id -> (N, 3, 17) predicted poses (the
        stored/pkl format, transposed like the reference's).
      actors_gt: sequence over actors of per-frame GT; actors_gt[a][f] is a
        (14, 3) Shelf-order pose or an empty array when absent (the
        `actorsGT.mat` layout, `src/evalmodel.py:136-137,150`).
      num_report_actors: actors shown in the table (reference: 3).

    Returns:
      dict with 'check_result' (F, A, 10), 'table' (str), per-group and
      per-actor percentages.
    """
    n_actors = len(actors_gt)
    n_frames = len(actors_gt[0])
    for start, end in eval_ranges:
        if not (0 <= start <= end <= n_frames):
            raise ValueError(
                f"EVAL_RANGE [{start}, {end}) outside GT frame range "
                f"[0, {n_frames}) — actorsGT.mat holds {n_frames} frames"
            )
    check = np.zeros((n_frames, n_actors, 10), np.int32)

    for start, end in eval_ranges:
        for f in range(start, end):
            preds = np.asarray(multi_poses3d.get(f, []), np.float64)
            for a in range(n_actors):
                gt = np.asarray(actors_gt[a][f], np.float64)
                if gt.size == 0 or gt.shape[-1] != 3:
                    continue
                if len(preds) == 0:
                    check[f, a, :] = -1
                    continue
                model_poses = np.stack([coco2shelf3d(p) for p in preds])
                d = nan_masked_sqdist(gt, model_poses)
                model = model_poses[int(np.argmin(d))]
                for i, (s, e) in enumerate(BONES):
                    ok = bone_is_right(model[s], model[e], gt[s], gt[e])
                    check[f, a, i] = 1 if ok else -1
                gt_hip = (gt[2] + gt[3]) / 2
                model_hip = (model[2] + model[3]) / 2
                ok = bone_is_right(model_hip, model[12], gt_hip, gt[12])
                check[f, a, -1] = 1 if ok else -1

    def ratio(x):
        denom = np.sum(np.abs(x))
        return np.sum(x > 0) / denom if denom else np.nan

    person_wise = np.array(
        [ratio(check[:, a, :]) for a in range(n_actors)]
    )
    group_person = OrderedDict()
    for name, idx in BONE_GROUPS.items():
        group_person[name] = np.array(
            [ratio(check[:, a, idx]) for a in range(n_actors)]
        )

    k = min(num_report_actors, n_actors)
    tb = Table(
        ["Bone Group"] + [f"Actor {i}" for i in range(k)] + ["Average"]
    )
    for name, vals in group_person.items():
        row = [name] + [f"{v * 100:.2f}" for v in vals[:k]]
        row.append(f"{np.nansum(vals[:k]) * 100 / k:.2f}")
        tb.add_row(row)
    total_row = ["Total"] + [f"{v * 100:.2f}" for v in person_wise[:k]]
    total_row.append(f"{np.nansum(person_wise[:k]) * 100 / k:.2f}")
    tb.add_row(total_row)

    return {
        "check_result": check,
        "person_wise": person_wise,
        "bone_person_wise": group_person,
        "total_avg": ratio(check),
        "average": float(np.nansum(person_wise[:k]) / k),
        "table": str(tb),
    }


def load_actors_gt_mat(gt_path, dataset_name):
    """Load `actorsGT.mat` the way the reference does
    (`src/evalmodel.py:136-139`)."""
    import scipy.io as scio

    actors = scio.loadmat(osp.join(gt_path, "actorsGT.mat"))["actor3D"][0]
    if dataset_name == "Panoptic":
        actors = actors / 100.0  # mm -> m
    # actors[a][f][0] is the (14, 3) pose or an empty array.
    return [[actors[a][f][0] for f in range(len(actors[a]))] for a in range(len(actors))]


def evaluate_pcp_from_pickle(eval_ranges, pred_path, gt_path, dataset_name):
    """File-level equivalent of `Evaluate3DPose_PCP` (same artifacts)."""
    with open(pred_path, "rb") as f:
        multi_poses3d = pickle.load(f)
    actors_gt = load_actors_gt_mat(gt_path, dataset_name)
    return evaluate_pcp(eval_ranges, multi_poses3d, actors_gt)
