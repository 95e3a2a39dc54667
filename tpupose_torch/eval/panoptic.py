"""CMU Panoptic AP / Recall / MPJPE scoring.

Counterpart of `tpupose/eval/panoptic.py`, a formula port of
`EvaluatePanoptic` (`src/evalmodel.py:208-350`): GT from
`body3DScene_*.json` every 12th file with an axis swap and cm -> mm
scaling; predictions converted COCO-17 -> 14 joints with an inserted pelvis
and scaled m -> mm; AP at MPJPE thresholds 25..150 mm, MPJPE at 500 mm.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
import pickle

import numpy as np

from tpupose_torch.eval.transforms import coco2panoptic14
from tpupose_torch.utils.tables import Table

#: Axis swap applied to Panoptic GT (`src/evalmodel.py:236-239`).
GT_AXES_M = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])

MPJPE_THRESHOLDS = np.arange(25, 155, 25)


def load_panoptic_gt(data_root, interval=12):
    """GT dict timestamp -> {'joints_3d': [(14,3) mm], 'joints_3d_vis': [...]}
    (`src/evalmodel.py:212-248`)."""
    anno_dir = osp.join(data_root, "hdPose3d_stage1_coco19")
    files = sorted(glob.iglob(f"{anno_dir}/*.json"))
    gt = {}
    for i, filename in enumerate(files):
        if i % interval != 0:
            continue
        timestamp = osp.basename(filename)[:-5].replace("body3DScene_", "")
        with open(filename) as f:
            bodies = json.load(f)["bodies"]
        if not bodies:
            continue
        poses, viss = [], []
        for body in bodies:
            pose = np.array(body["joints19"]).reshape(-1, 4)[1:15]
            vis = pose[:, -1] > 0.1
            if not vis[2]:
                continue
            pose[:, :3] = pose[:, :3] @ GT_AXES_M
            poses.append(pose[:, :3] * 10.0)
            viss.append(np.repeat(vis[:, None], 3, axis=1))
        gt[int(timestamp)] = {"joints_3d": poses, "joints_3d_vis": viss}
    return gt


def ap_from_eval_list(eval_list, total_gt, threshold):
    """Greedy TP/FP AP with monotone precision envelope
    (`src/evalmodel.py:250-274`)."""
    total = len(eval_list)
    tp = np.zeros(total)
    fp = np.zeros(total)
    seen = set()
    for i, item in enumerate(eval_list):
        if item["mpjpe"] < threshold and item["gt_id"] not in seen:
            tp[i] = 1
            seen.add(item["gt_id"])
        else:
            fp[i] = 1
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / (total_gt + 1e-5)
    precise = tp / (tp + fp + 1e-5)
    for n in range(total - 2, -1, -1):
        precise[n] = max(precise[n], precise[n + 1])
    precise = np.concatenate(([0], precise, [0]))
    recall = np.concatenate(([0], recall, [1]))
    idx = np.where(recall[1:] != recall[:-1])[0]
    ap = np.sum((recall[idx + 1] - recall[idx]) * precise[idx + 1])
    return ap, recall[-2]


def mpjpe_from_eval_list(eval_list, threshold=500):
    seen, vals = set(), []
    for item in eval_list:
        if item["mpjpe"] < threshold and item["gt_id"] not in seen:
            vals.append(item["mpjpe"])
            seen.add(item["gt_id"])
    return float(np.mean(vals)) if vals else np.inf


def recall_from_eval_list(eval_list, total_gt, threshold=500):
    ids = {e["gt_id"] for e in eval_list if e["mpjpe"] < threshold}
    return len(ids) / total_gt


def evaluate_panoptic(gts, preds):
    """Score predictions (dict timestamp -> (N, 3, 17) meters) against GT.

    Returns (aps, recalls, mpjpe, recall500) like `evaluate`
    (`src/evalmodel.py:291-337`).
    """
    eval_list = []
    total_gt = 0
    for timestamp, gt in gts.items():
        joints_3d = gt["joints_3d"]
        joints_vis = gt["joints_3d_vis"]
        if len(joints_3d) == 0:
            continue
        for pose in preds[timestamp]:
            p = coco2panoptic14(pose) * 1000.0  # (14, 3) mm
            mpjpes = []
            for g, gv in zip(joints_3d, joints_vis):
                vis = gv[:, 0] > 0
                mpjpes.append(
                    float(np.mean(np.linalg.norm(p[vis] - g[vis], axis=-1)))
                )
            k = int(np.argmin(mpjpes))
            eval_list.append({"mpjpe": float(mpjpes[k]), "gt_id": int(total_gt + k)})
        total_gt += len(joints_3d)

    aps, recs = [], []
    for t in MPJPE_THRESHOLDS:
        ap, rec = ap_from_eval_list(eval_list, total_gt, t)
        aps.append(ap)
        recs.append(rec)
    return (
        aps,
        recs,
        mpjpe_from_eval_list(eval_list),
        recall_from_eval_list(eval_list, total_gt),
    )


def evaluate_panoptic_from_pickle(pred_path, data_root):
    """File-level equivalent of `EvaluatePanoptic` (same table output)."""
    with open(pred_path, "rb") as f:
        preds = pickle.load(f)
    gts = load_panoptic_gt(data_root)
    aps, recs, mpjpe, _ = evaluate_panoptic(gts, preds)
    tb = Table(["Threshold/mm"] + [str(t) for t in MPJPE_THRESHOLDS])
    tb.add_row(["AP"] + [f"{ap * 100:.2f}" for ap in aps])
    tb.add_row(["Recall"] + [f"{r * 100:.2f}" for r in recs])
    print(tb)
    print(f"MPJPE: {mpjpe:.2f}mm")
    return {"aps": aps, "recalls": recs, "mpjpe": mpjpe, "table": str(tb)}
