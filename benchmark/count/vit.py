"""The operations and bytes of one frame of stage A with ViTPose as the
pose net, from the cell's shapes: YOLOv3's convs (`ops.conv_items`), the
preprocessing's resample products (`ops.matmul_item`), and ViTPose's
layers, counted from its published equations (`reference/vitpose.py`).

ViTPose's items: kind "matmul" for each block's `qkv`, `proj`, `fc1` and
`fc2`, 2 m k n operations, bytes of the input, weight and output in bf16;
kind "attention" for each block's softmax attention, 4 B h T^2 d
operations (the scores and their product with v), bytes of q, k, v and
the output in bf16; kind "conv", the kind of what runs on cuDNN, for the
patch embedding (a 16x16 stride-16 conv: the product of (T, 3 p^2)
patches and (3 p^2, C) weights a crop), the head's transposed convs
(2 N Cin Cout k^2 Hin Win) and its 1x1 layer.
LayerNorm, GELU and the adds are elementwise and not counted, as the
networks' activations and adds are not.
"""
from __future__ import annotations

from benchmark.count import ops
from benchmark.reference import nets
from benchmark.reference.vitpose import tokens_of


def _item(kind, name, ops_, bytes_):
    return {"kind": kind, "net": "vitpose", "name": name, "precision": "bf16",
            "ops": ops_, "bytes": bytes_}


def _matmul(name, m, k, n):
    return _item("matmul", name, 2 * m * k * n, 2 * (m * k + k * n + m * n))


def vit_items(pose, crops):
    """Items of one ViTPose forward over `crops` crops."""
    c, p, heads = pose["embed_dim"], pose["patch_size"], pose["num_heads"]
    gh, gw = tokens_of(pose)
    t = gh * gw
    m, hidden = crops * t, c * pose["mlp_ratio"]
    patch = _matmul("patch_embed", m, 3 * p * p, c)
    items = [dict(patch, kind="conv")]
    for i in range(pose["depth"]):
        b = f"blocks.{i}"
        items += [_matmul(f"{b}.attn.qkv", m, c, 3 * c),
                  _item("attention", f"{b}.attn", 4 * crops * heads * t * t * (c // heads),
                        4 * 2 * m * c),
                  _matmul(f"{b}.attn.proj", m, c, c),
                  _matmul(f"{b}.mlp.fc1", m, c, hidden),
                  _matmul(f"{b}.mlp.fc2", m, hidden, c)]
    cin, k, h, w = c, pose["deconv_kernel"], gh, gw
    for j, planes in enumerate(pose["deconv_filters"]):
        wts = cin * planes * k * k
        items.append(_item("conv", f"deconv_layers.{3 * j}", 2 * crops * wts * h * w,
                           2 * (crops * cin * h * w + wts + crops * planes * 4 * h * w)))
        cin, h, w = planes, 2 * h, 2 * w
    j = pose["num_joints"]
    items.append(_item("conv", "final_layer", 2 * crops * cin * j * h * w,
                       2 * (crops * cin * h * w + cin * j + crops * j * h * w)))
    return items


def frame_work(config):
    """Items of one frame (all of the rig's views) of stage A."""
    det, pose, rig = config["detector"], config["pose"], config["rig"]
    views, h, w = rig["views"], rig["height"], rig["width"]
    s, k = det["input_size"], det["max_candidates"]
    ph, pw = pose["input_size"]
    yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
    items = ops.conv_items(yspecs, nets.yolo_forward, (views, 3, s, s), "yolov3", set())
    items += vit_items(pose, views * k)
    items += [ops.matmul_item("resize rows", s, h, w * 3, views),
              ops.matmul_item("resize columns", s, w, s * 3, views),
              ops.matmul_item("crop rows", ph, h, w * 3, views * k),
              ops.matmul_item("crop columns", pw, w, ph * 3, views * k)]
    return items

