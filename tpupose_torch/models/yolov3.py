"""YOLOv3 person detector as an nn.Module (in its input's layout).

Counterpart of `tpupose/models/yolov3.py`: Darknet-53 backbone, three
detection scales with the COCO anchors, person-class decode, top-K and
greedy NMS. Convolutions keep darknet file order (`conv0` .. `conv74`),
each a module with `conv` (and `bn` where darknet has batch norm), so the
state_dict keys are `conv{i}.conv.weight`, `conv{i}.conv.bias` and
`conv{i}.bn.*`, as in the JAX package's trees. `detect_people` hands the
network a channels-last view of its NHWC images (`ops.layout`), so that
the network computes in the JAX package's NHWC.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tpupose_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    he_normal_init_,
    leaky_relu,
    upsample_nearest,
)
from tpupose_torch.ops.image import letterbox_resize, resize_bilinear
from tpupose_torch.ops.nms import nms


def _conv_specs(num_classes=80, width_mult=1.0):
    """(out_channels, kernel, stride, batchnorm) in darknet cfg order."""
    def c(ch):
        return max(int(ch * width_mult), 1)

    spec = []

    def conv(ch, k, s, bn=True):
        spec.append((c(ch) if bn else ch, k, s, bn))

    def res_block(ch, n):
        for _ in range(n):
            conv(ch // 2, 1, 1)
            conv(ch, 3, 1)

    out_ch = 3 * (5 + num_classes)
    conv(32, 3, 1)
    conv(64, 3, 2); res_block(64, 1)
    conv(128, 3, 2); res_block(128, 2)
    conv(256, 3, 2); res_block(256, 8)      # conv25 out -> route (stride 8)
    conv(512, 3, 2); res_block(512, 8)      # conv42 out -> route (stride 16)
    conv(1024, 3, 2); res_block(1024, 4)    # conv51 out (stride 32)
    conv(512, 1, 1); conv(1024, 3, 1); conv(512, 1, 1)
    conv(1024, 3, 1); conv(512, 1, 1)       # conv56 -> branch A
    conv(1024, 3, 1)
    spec.append((out_ch, 1, 1, False))      # conv58: detection
    conv(256, 1, 1)                          # conv59, then upsample
    conv(256, 1, 1); conv(512, 3, 1); conv(256, 1, 1)
    conv(512, 3, 1); conv(256, 1, 1)        # conv64 -> branch B
    conv(512, 3, 1)
    spec.append((out_ch, 1, 1, False))      # conv66: detection
    conv(128, 1, 1)                          # conv67, then upsample
    conv(128, 1, 1); conv(256, 3, 1); conv(128, 1, 1)
    conv(256, 3, 1); conv(128, 1, 1)
    conv(256, 3, 1)
    spec.append((out_ch, 1, 1, False))      # conv74: detection
    return spec


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 80
    input_size: int = 416
    score_thresh: float = 0.5
    nms_thresh: float = 0.4
    max_candidates: int = 64  # top-K person candidates fed to NMS
    width_mult: float = 1.0
    #: False = plain resize to (S, S) (the reference backend); True =
    #: darknet letterbox.
    letterbox: bool = False

    @property
    def anchors(self):
        # (scale, anchor, wh) in input pixels; scale order: stride 32, 16, 8.
        return (
            ((116, 90), (156, 198), (373, 326)),
            ((30, 61), (62, 45), (59, 119)),
            ((10, 13), (16, 30), (33, 23)),
        )

    @property
    def conv_specs(self):
        return _conv_specs(self.num_classes, self.width_mult)


def tiny_yolo_test_config():
    return YoloConfig(num_classes=2, input_size=64, width_mult=1 / 16,
                      max_candidates=16)


def conv_in_channels(cfg: YoloConfig):
    """Input channels per conv index."""
    specs = cfg.conv_specs
    cins = []
    cin = 3
    for i, (cout, k, s, bn) in enumerate(specs):
        if i == 60:
            cin = specs[59][0] + specs[42][0]
        elif i == 68:
            cin = specs[67][0] + specs[25][0]
        cins.append(cin)
        cin = cout
        if i == 58:
            cin = specs[56][0]
        elif i == 66:
            cin = specs[64][0]
    return cins


class ConvBlock(nn.Module):
    """Darknet conv: conv + BN + leaky ReLU, or a plain biased conv."""

    def __init__(self, cin, cout, k, stride, bn):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, bias=not bn)
        self.bn = BatchNorm2d(cout) if bn else None
        self.act = bn

    def forward(self, x):
        y = self.conv(x)
        if self.act:
            y = leaky_relu(self.bn(y))
        return y


class YOLOv3(nn.Module):
    """Backbone + heads: (N, 3, S, S) in [0, 1] -> three raw f32 head
    outputs (N, A*(5+C), S/32, S/32), (stride 16), (stride 8), in the
    input's layout."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        self.specs = cfg.conv_specs
        for i, ((cout, k, s, bn), cin) in enumerate(zip(self.specs,
                                                         conv_in_channels(cfg))):
            setattr(self, f"conv{i}", ConvBlock(cin, cout, k, s, bn))

    def run(self, i, x):
        return getattr(self, f"conv{i}")(x)

    def forward(self, x, compute_dtype=torch.bfloat16):
        x = x.to(compute_dtype)

        def res_chain(x, i, n):
            for _ in range(n):
                x = x + self.run(i + 1, self.run(i, x))
                i += 2
            return x, i

        x = self.run(0, x)
        x = self.run(1, x); x, i = res_chain(x, 2, 1)
        x = self.run(i, x); x, i = res_chain(x, i + 1, 2)
        x = self.run(i, x); x, i = res_chain(x, i + 1, 8)
        route25 = x
        x = self.run(i, x); x, i = res_chain(x, i + 1, 8)
        route42 = x
        x = self.run(i, x); x, i = res_chain(x, i + 1, 4)
        assert i == 52, i
        for j in range(52, 57):
            x = self.run(j, x)
        branch_a = x
        det1 = self.run(58, self.run(57, x))
        x = upsample_nearest(self.run(59, branch_a), 2)
        x = torch.cat([x, route42], dim=1)
        for j in range(60, 65):
            x = self.run(j, x)
        branch_b = x
        det2 = self.run(66, self.run(65, x))
        x = upsample_nearest(self.run(67, branch_b), 2)
        x = torch.cat([x, route25], dim=1)
        for j in range(68, 73):
            x = self.run(j, x)
        det3 = self.run(74, self.run(73, x))
        return [d.to(torch.float32) for d in (det1, det2, det3)]


def yolov3_init(cfg: YoloConfig, generator: torch.Generator) -> YOLOv3:
    """A YOLOv3 with He-normal random weights drawn from `generator`."""
    return he_normal_init_(YOLOv3(cfg), generator)


def decode_detections(cfg: YoloConfig, heads, class_id=0):
    """Raw (N, A*(5+C), h, w) head outputs, NCHW or channels-last -> (N, P,
    4) xyxy boxes in input pixels and (N, P) scores = objectness * class
    probability (anchor order as the JAX package's NHWC reshape; on a
    channels-last head the NHWC permute is free)."""
    size = cfg.input_size
    all_boxes, all_scores = [], []
    for head, anchors in zip(heads, cfg.anchors):
        head = head.permute(0, 2, 3, 1)  # NHWC
        n, gh, gw, _ = head.shape
        stride = size // gw
        a = len(anchors)
        head = head.reshape(n, gh, gw, a, 5 + cfg.num_classes)
        dev = head.device
        cy = torch.arange(gh, dtype=torch.float32, device=dev)[None, :, None, None]
        cx = torch.arange(gw, dtype=torch.float32, device=dev)[None, None, :, None]
        bx = (torch.sigmoid(head[..., 0]) + cx) * stride
        by = (torch.sigmoid(head[..., 1]) + cy) * stride
        aw = torch.tensor([w for w, h in anchors], dtype=torch.float32, device=dev)
        ah = torch.tensor([h for w, h in anchors], dtype=torch.float32, device=dev)
        bw = torch.exp(head[..., 2]) * aw
        bh = torch.exp(head[..., 3]) * ah
        obj = torch.sigmoid(head[..., 4])
        cls = torch.sigmoid(head[..., 5 + class_id])
        boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                            dim=-1)
        all_boxes.append(boxes.reshape(n, -1, 4))
        all_scores.append((obj * cls).reshape(n, -1))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def prepare_yolo_images(cfg: YoloConfig, x):
    """(N, H, W, 3) floats in [0, 1] -> (N, S, S, 3) network input,
    contiguous: the resize's products leave W-major memory, and the
    network reads the images' channels-last view (`detect_people`)."""
    s = cfg.input_size
    if cfg.letterbox:
        return letterbox_resize(x, s, fill=0.5).contiguous()
    return resize_bilinear(x, (s, s)).contiguous()


def yolo_box_mapping(cfg: YoloConfig, image_hw, device=None):
    """(scale4, offset4) with orig = (box_in_input - offset) * scale."""
    oh, ow = image_hw
    s = cfg.input_size
    if cfg.letterbox:
        r = min(s / oh, s / ow)
        nh, nw = round(oh * r), round(ow * r)
        top, left = (s - nh) // 2, (s - nw) // 2
        scale = torch.full((4,), 1.0 / r, dtype=torch.float32, device=device)
        offset = torch.tensor([left, top, left, top], dtype=torch.float32,
                              device=device)
    else:
        scale = torch.tensor([ow / s, oh / s] * 2, dtype=torch.float32,
                             device=device)
        offset = torch.zeros(4, dtype=torch.float32, device=device)
    return scale, offset


def detect_people(model: YOLOv3, cfg: YoloConfig, images, image_hw,
                  compute_dtype=torch.bfloat16):
    """Forward + decode + top-K + NMS.

    Args:
      images: (N, S, S, 3) in [0, 1] from `prepare_yolo_images` (NHWC).
      image_hw: (orig_h, orig_w) for scaling boxes back.
      compute_dtype: the network's compute dtype (bf16 serving).

    Returns:
      boxes (N, K, 4) in original-image pixels (clipped), scores (N, K),
      valid (N, K) bool.
    """
    # a channels-last view of the NHWC images: no layout copy
    heads = model(images.permute(0, 3, 1, 2), compute_dtype)
    boxes, scores = decode_detections(cfg, heads)
    k = cfg.max_candidates
    # Stable sort: equal scores keep the lower index first, as lax.top_k.
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    valid = top_scores > cfg.score_thresh
    keep = nms(top_boxes, top_scores, valid, cfg.nms_thresh)
    oh, ow = image_hw
    scale, offset = yolo_box_mapping(cfg, image_hw, device=boxes.device)
    out_boxes = (top_boxes - offset) * scale
    zero = torch.zeros(4, dtype=torch.float32, device=boxes.device)
    hi = torch.tensor([ow, oh, ow, oh], dtype=torch.float32, device=boxes.device)
    out_boxes = torch.minimum(torch.maximum(out_boxes, zero), hi)
    return out_boxes, top_scores, valid & keep
