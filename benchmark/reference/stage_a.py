"""Stage A of the pipeline in plain PyTorch: the reference's preprocessing,
detector decode, top-K and NMS, pose crops and heatmap decode.

Semantics as published for the top-down pipeline (half-pixel bilinear
resize, YOLOv3's COCO anchors and person class, greedy NMS, HRNet's
aspect-expanded crops, ImageNet normalization, the argmax with the quarter
offset toward the stronger neighbour), written here without the
program's code. Images are NHWC, networks run NCHW, all in float32.
"""
from __future__ import annotations

import torch

ANCHORS = (((116, 90), (156, 198), (373, 326)),
           ((30, 61), (62, 45), (59, 119)),
           ((10, 13), (16, 30), (33, 23)))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _taps(coords, size):
    c = torch.clamp(coords, 0.0, size - 1.0)
    i = torch.arange(size, dtype=torch.float32, device=c.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - i), min=0.0)


def resize(images, out_hw):
    """(N, H, W, C) -> (N, h, w, C), bilinear, half-pixel centres, edge clamp."""
    _, h, w, _ = images.shape
    oh, ow = out_hw
    dev = images.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (w / ow) - 0.5
    tmp = torch.einsum("oh,nhwc->nowc", _taps(ys, h), images)
    return torch.einsum("pw,nowc->nopc", _taps(xs, w), tmp)


def crop(images, boxes, out_hw):
    """(N, H, W, C) images, (N, K, 4) xyxy boxes -> (N, K, h, w, C) bilinear
    crops (box edges map to pixel edges; sampling edge-clamps)."""
    _, h, w, _ = images.shape
    oh, ow = out_hw
    dev = images.device
    gy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    gx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    ys = boxes[..., 1:2] + gy * (boxes[..., 3:4] - boxes[..., 1:2]) - 0.5
    xs = boxes[..., 0:1] + gx * (boxes[..., 2:3] - boxes[..., 0:1]) - 0.5
    tmp = torch.einsum("nkoh,nhwc->nkowc", _taps(ys, h), images)
    return torch.einsum("nkpw,nkowc->nkopc", _taps(xs, w), tmp)


def normalize(x):
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def expand_to_aspect(boxes, aspect_h_over_w):
    """Grow (..., 4) boxes about their centres to the model's aspect."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    th = torch.maximum(y1 - y0, (x1 - x0) * aspect_h_over_w)
    tw = th / aspect_h_over_w
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    return torch.stack([cx - tw / 2, cy - th / 2, cx + tw / 2, cy + th / 2], -1)


def decode_heads(heads, input_size, num_classes=80):
    """Three (N, 3 * (5 + C), g, g) heads -> (N, P, 4) xyxy boxes in input
    pixels and (N, P) person scores, cells in (row, column, anchor) order."""
    boxes, scores = [], []
    for head, anchors in zip(heads, ANCHORS):
        n, _, gh, gw = head.shape
        stride = input_size // gw
        t = head.permute(0, 2, 3, 1).reshape(n, gh, gw, len(anchors), 5 + num_classes)
        cy = torch.arange(gh, dtype=torch.float32, device=t.device)[None, :, None, None]
        cx = torch.arange(gw, dtype=torch.float32, device=t.device)[None, None, :, None]
        bx = (torch.sigmoid(t[..., 0]) + cx) * stride
        by = (torch.sigmoid(t[..., 1]) + cy) * stride
        aw = torch.tensor([a[0] for a in anchors], dtype=torch.float32, device=t.device)
        ah = torch.tensor([a[1] for a in anchors], dtype=torch.float32, device=t.device)
        bw, bh = torch.exp(t[..., 2]) * aw, torch.exp(t[..., 3]) * ah
        boxes.append(torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                                 -1).reshape(n, -1, 4))
        scores.append((torch.sigmoid(t[..., 4]) * torch.sigmoid(t[..., 5])).reshape(n, -1))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def iou(a, b):
    """(..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    area_a = torch.clamp(a[..., 2:] - a[..., :2], min=0).prod(-1)
    area_b = torch.clamp(b[..., 2:] - b[..., :2], min=0).prod(-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union == 0, torch.ones_like(union), union)


def nms_keep(boxes, scores, valid, thresh):
    """Greedy NMS per image over K candidates, highest valid score first
    (ties to the lower index): (N, K) bool keep flags."""
    n, k = scores.shape
    keep = torch.zeros_like(valid)
    order = torch.argsort(-torch.where(valid, scores, torch.full_like(scores, -torch.inf)),
                          dim=1, stable=True)
    for i in range(n):
        ious = iou(boxes[i], boxes[i])
        taken = []
        for j in order[i].tolist():
            if bool(valid[i, j]) and not (taken and bool((ious[j, taken] > thresh).any())):
                taken.append(j)
                keep[i, j] = True
    return keep


def select(boxes, scores, k, score_thresh, nms_thresh, image_hw, input_size):
    """Top-K (stable: equal scores keep the lower index first), score gate,
    NMS, and the boxes scaled to the image and clipped. Returns (N, K, 4)
    boxes, (N, K) scores and (N, K) valid flags."""
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    valid = top > score_thresh
    valid = valid & nms_keep(b, top, valid, nms_thresh)
    oh, ow = image_hw
    scale = torch.tensor([ow / input_size, oh / input_size] * 2, device=b.device)
    hi = torch.tensor([ow, oh, ow, oh], dtype=torch.float32, device=b.device)
    return torch.minimum(torch.clamp(b * scale, min=0), hi), top, valid


def heatmap_cells(heat):
    """(N, J, h, w) -> the (N, J) row and column of each map's first
    maximum in row-major order."""
    n, j, h, w = heat.shape
    flat = heat.reshape(n, j, h * w)
    at = torch.argmax(flat, -1)
    return at // w, at % w


def decode_heatmaps(heat, boxes):
    """(N, J, h, w) heatmaps, (N, 4) crop boxes -> (N, J, 3) (x, y, score):
    the first maximum, a quarter cell toward the larger neighbour inside
    the map, mapped through the box."""
    n, j, h, w = heat.shape
    yi, xi = heatmap_cells(heat)
    score = heat.reshape(n, j, -1).amax(-1)
    px, py = xi.float(), yi.float()

    def at(y, x):
        y, x = y.clamp(0, h - 1), x.clamp(0, w - 1)
        return torch.gather(heat.reshape(n, j, -1), 2, (y * w + x)[..., None])[..., 0]

    inner = (xi >= 1) & (xi < w - 1) & (yi >= 1) & (yi < h - 1)
    dx = torch.sign(at(yi, xi + 1) - at(yi, xi - 1))
    dy = torch.sign(at(yi + 1, xi) - at(yi - 1, xi))
    px = px + torch.where(inner, 0.25 * dx, torch.zeros_like(px))
    py = py + torch.where(inner, 0.25 * dy, torch.zeros_like(py))
    bw, bh = boxes[:, 2:3] - boxes[:, 0:1], boxes[:, 3:4] - boxes[:, 1:2]
    return torch.stack([boxes[:, 0:1] + px / w * bw, boxes[:, 1:2] + py / h * bh, score], -1)
