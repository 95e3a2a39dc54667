"""Greedy non-maximum suppression over fixed-size candidate sets
(counterpart of `tpupose/ops/nms.py`), batched over images."""
from __future__ import annotations

import torch


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of (..., N, 4) x (..., M, 4) boxes (x0, y0, x1, y1)."""
    ax0, ay0, ax1, ay1 = boxes_a.unbind(-1)
    bx0, by0, bx1, by1 = boxes_b.unbind(-1)
    ix0 = torch.maximum(ax0[..., :, None], bx0[..., None, :])
    iy0 = torch.maximum(ay0[..., :, None], by0[..., None, :])
    ix1 = torch.minimum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.minimum(ay1[..., :, None], by1[..., None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    area_a = torch.clamp(ax1 - ax0, min=0) * torch.clamp(ay1 - ay0, min=0)
    area_b = torch.clamp(bx1 - bx0, min=0) * torch.clamp(by1 - by0, min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union == 0, torch.ones_like(union), union)


def nms(boxes, scores, valid, iou_thresh):
    """Greedy NMS.

    Args:
      boxes: (..., K, 4); scores: (..., K); valid: (..., K) bool.

    Returns:
      keep: (..., K) bool, surviving boxes in the original index order.
    """
    k = boxes.shape[-2]
    neg_inf = torch.full_like(scores, -torch.inf)
    # Stable: equal scores keep the lower index first, as jnp.argsort does.
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    v = torch.gather(valid, -1, order)
    iou = iou_matrix(b, b)
    keep = []
    suppressed = torch.zeros_like(v)
    for i in range(k):
        take = v[..., i] & ~suppressed[..., i]
        keep.append(take)
        suppressed = suppressed | (take[..., None] & (iou[..., i, :] > iou_thresh))
    keep_sorted = torch.stack(keep, dim=-1)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
