"""The numbers that decide `correct`: the program's outputs held against
the reference's.

Stage A (`stage_a_numbers`), for a sample of images:
  yolo_head_err      the largest relative gap, over the sampled images, of
                     the program's raw detector heads from the
                     reference's (L2 over the three heads of an image);
  det_mask_mismatch  slots whose validity differs from the reference's
                     top-K, score gate and NMS run on the program's own
                     heads (the decode followed step by step; exact);
  kp_argmax_gap      for each keypoint, how far the reference's heatmap
                     at the program's argmax cell lies below its maximum,
                     as a share of the map's range (max - min); a keypoint
                     off the map counts 1;
                     (keypoints of a crop box under a pixel wide, whose
                     cell cannot be read back, count 0: kp_unjudged_share);
  kp_score_gap       |program score - reference maximum| over that range.
The reference's heatmaps are of crops at the boxes its own decode of the
program's heads gives, so a gap is the pose net's and the decode's alone.

Stage B (`tracker_numbers`), over every frame of every sequence: the
program's valid outputs and the reference tracker's, matched by pose
(Hungarian on the mean joint distance, gated at `gate_m`):
  track_unmatched_share  outputs on either side without a match, over all;
  track_pose_gap_m       the largest joint gap of a matched pair;
  track_id_switches      times a program id meets another reference id
                         than it met before in the sequence;
  track_gap_p75_m        the 75th percentile, over every output of either
                         side, of its matched pair's joint gap, an output
                         without a match counting as UNMATCHED_M: the
                         precision of the bulk of the poses;
  track_off_share        outputs of either side that are off, over all: an
                         output without a match, one of a pair whose joints
                         lie more than `off_m` apart, or one of a pair whose
                         ids break with their last pairing, either way (a
                         program id met with another reference id than
                         before, or a reference id with another program
                         id). Validity, 3D poses and track ids in one share:
                         a tracker that loses, moves, replaces or renames
                         one of four actors in every frame reads an eighth
                         or more.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

#: The gap of a tracker output that has no counterpart (metres; finite, so
#: that the result line stays plain JSON).
UNMATCHED_M = 1e6


def stage_a_numbers(ref, images, heads, kps, mask):
    """images (N, H, W, 3) uint8; the program's `heads` (three (N, ...)
    tensors), keypoints (N, K, J, 3) and mask (N, K), all on one device."""
    ref_heads = ref.yolo_heads(images)
    num = sum(((p.float() - r) ** 2).flatten(1).sum(1) for p, r in zip(heads, ref_heads))
    den = sum((r ** 2).flatten(1).sum(1) for r in ref_heads)
    yolo_err = float(torch.sqrt(num / torch.clamp(den, min=1e-30)).max())
    boxes, _, valid = ref.detect([h.float() for h in heads], images.shape[1:3])
    mismatch = int((valid != mask).sum())
    heat, eboxes = ref.heatmaps(images, boxes)
    n, j, h, w = heat.shape
    kp = kps.reshape(n, j, 3).float()
    bw = (eboxes[:, 2] - eboxes[:, 0])[:, None]
    bh = (eboxes[:, 3] - eboxes[:, 1])[:, None]
    px = torch.round((kp[..., 0] - eboxes[:, 0:1]) / bw * w)
    py = torch.round((kp[..., 1] - eboxes[:, 1:2]) / bh * h)
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # a crop box under a pixel wide (a detection clipped to the image's
    # edge) maps every cell to one point: its argmax cannot be read back
    judged = ((bw > 1) & (bh > 1)).expand_as(px)
    flat = heat.reshape(n, j, h * w)
    hmax, hmin = flat.amax(-1), flat.amin(-1)
    span = torch.clamp(hmax - hmin, min=1e-30)
    cell = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).nan_to_num(0).long()
    at = torch.gather(flat, 2, cell[..., None])[..., 0]
    gap = torch.where(inside, (hmax - at) / span, torch.ones_like(span)).nan_to_num(1.0)
    gap = torch.where(judged, gap, torch.zeros_like(gap))
    score_gap = ((kp[..., 2] - hmax).abs() / span).nan_to_num(1e30, 1e30)
    return {"yolo_head_err": yolo_err, "det_mask_mismatch": mismatch,
            "kp_argmax_gap": float(gap.max()), "kp_argmax_gap_mean": float(gap.mean()),
            "kp_argmax_differs": float((gap > 0).float().mean()),
            "kp_score_gap": float(score_gap.max()), "kp_score_gap_mean": float(score_gap.mean()),
            "kp_unjudged_share": float((~judged).float().mean()),
            "stage_a_images": int(len(images))}


def tracker_numbers(sequences, gate_m=0.5, off_m=0.01):
    """`sequences`: lists of (program frame, reference frame) pairs, each
    frame a dict {track id: (J, 3) pose}."""
    unmatched = total = switches = off = 0
    gaps, per_output = [], []
    for seq in sequences:
        seen, seen_ref = {}, {}
        for prog, ref in seq:
            total += len(prog) + len(ref)
            pairs = []
            if prog and ref:
                pid, rid = list(prog), list(ref)
                cost = np.array([[np.linalg.norm(prog[a] - ref[b], axis=-1).mean()
                                  for b in rid] for a in pid])
                rows, cols = linear_sum_assignment(cost)
                pairs = [(pid[r], rid[c]) for r, c in zip(rows, cols) if cost[r, c] < gate_m]
            unmatched += len(prog) + len(ref) - 2 * len(pairs)
            per_output += [UNMATCHED_M] * (len(prog) + len(ref) - 2 * len(pairs))
            for a, b in pairs:
                gaps.append(float(np.abs(prog[a] - ref[b]).max()))
                per_output += [gaps[-1]] * 2
                broken = seen.get(a, b) != b or seen_ref.get(b, a) != a
                switches += seen.get(a, b) != b
                off += 2 * (gaps[-1] > off_m or broken)
                seen[a], seen_ref[b] = b, a
    return {"track_unmatched_share": unmatched / total if total else 0.0,
            "track_pose_gap_m": max(gaps, default=0.0),
            "track_pose_gap_p50_m": float(np.median(gaps)) if gaps else 0.0,
            "track_pose_gap_p99_m": float(np.quantile(gaps, 0.99)) if gaps else 0.0,
            "track_gap_p75_m": float(np.quantile(per_output, 0.75, method="inverted_cdf"))
            if per_output else 0.0,
            "track_gap_p90_m": float(np.quantile(per_output, 0.9, method="inverted_cdf"))
            if per_output else 0.0,
            "track_off_share": (off + unmatched) / total if total else 0.0,
            "track_id_switches": switches, "track_outputs": total}


def program_frames(valid, track_id, pose3d):
    """Per-frame {id: pose} of a program's stacked outputs (numpy)."""
    return [{int(i): p.astype(np.float64) for i, p in zip(track_id[f][valid[f]],
                                                           pose3d[f][valid[f]])}
            for f in range(len(valid))]


def to_bf16(a):
    """`a` rounded to bfloat16 and back (numpy f64)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def reference_frames(oracle, detections, mask):
    """Run the reference tracker over (F, C, D, J, 3) detections with their
    (F, C, D) mask, frame ids 0 .. F-1; its per-frame {id: pose}."""
    out = []
    for f in range(len(detections)):
        oracle.step(f, [detections[f, c][mask[f, c]].astype(np.float64)
                        for c in range(detections.shape[1])])
        out.append({o["id"]: o["pose3d"] for o in oracle.outputs(f)})
    return out
