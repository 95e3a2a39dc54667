"""The operations and bytes of one frame of stage A with HRFormer as the
pose net, from the cell's shapes: YOLOv3's convs (`ops.conv_items`), the
preprocessing's resample products (`ops.matmul_item`), and HRFormer's
layers, counted from its published equations (`reference/hrformer.py`).

HRFormer's items, each by what runs it:
  kind "matmul"     each block's `qkv` and `proj` (cuBLAS), over the padded
                    map's tokens (the windows cover it whole), 2 m k n
                    operations, bytes of the input, weight and output in bf16;
  kind "attention"  each block's window attention, 4 B h T^2 d operations
                    (the scores and their product with v; B windows, T = 49
                    tokens, d = C / h, 39 in HRFormer-B: the unpadded head
                    dim), bytes of q, k, v and the output in bf16 at the
                    padded token counts;
  kind "conv"       everything cuDNN runs: the stem, stage 1, the
                    transitions, each FFN's fc1, depthwise dw3x3 and fc2,
                    the fuse layers' 1x1 and depthwise stride-2 convs, the
                    heatmap layer; 2 N Cout Hout Wout (Cin / groups) k^2
                    operations, bytes of the input, weights and output.
LayerNorm, GELU, the gathers into and out of window order, the bilinear
upsample and the adds are elementwise and not counted, as the other
networks' activations and adds are not.
"""
from __future__ import annotations

from benchmark.count import ops
from benchmark.reference import nets


def _item(kind, name, ops_, bytes_):
    return {"kind": kind, "net": "hrformer", "name": name, "precision": "bf16",
            "ops": ops_, "bytes": bytes_}


def conv_item(name, n, cin, cout, hw, k, stride=1, groups=1):
    """A conv's item and its output's (H, W) (padding k // 2)."""
    h, w = hw
    ho, wo = -(-h // stride), -(-w // stride)
    wts = cout * (cin // groups) * k * k
    return (_item("conv", name, 2 * n * cout * ho * wo * (cin // groups) * k * k,
                  2 * (n * cin * h * w + wts + n * cout * ho * wo)), (ho, wo))


def _matmul(name, m, k, n):
    return _item("matmul", name, 2 * m * k * n, 2 * (m * k + k * n + m * n))


def block_items(name, n, c, heads, hw, window, mlp_ratio):
    """One block's items over n crops of a (H, W) map of c channels."""
    h, w = hw
    windows = -(-h // window) * -(-w // window)
    t = window * window
    m = n * windows * t
    hidden = c * mlp_ratio
    return [_matmul(f"{name}.attn.qkv", m, c, 3 * c),
            _item("attention", f"{name}.attn", 4 * n * windows * heads * t * t * (c // heads),
                  4 * 2 * m * c),
            _matmul(f"{name}.attn.proj", m, c, c),
            conv_item(f"{name}.ffn.fc1", n, c, hidden, hw, 1)[0],
            conv_item(f"{name}.ffn.dw3x3", n, hidden, hidden, hw, 3, groups=hidden)[0],
            conv_item(f"{name}.ffn.fc2", n, hidden, c, hw, 1)[0]]


def hrformer_items(pose, crops):
    """Items of one HRFormer forward over `crops` crops."""
    n, items = crops, []

    def conv(name, cin, cout, hw, k, stride=1, groups=1):
        item, out = conv_item(name, n, cin, cout, hw, k, stride, groups)
        items.append(item)
        return out

    stem, planes = pose["stem_channels"], pose["layer1_planes"]
    hw = conv("conv1", 3, stem, tuple(pose["input_size"]), 3, 2)
    hw = conv("conv2", stem, stem, hw, 3, 2)
    cin = stem
    for i in range(pose["layer1_blocks"]):
        conv(f"layer1.{i}.conv1", cin, planes, hw, 1)
        conv(f"layer1.{i}.conv2", planes, planes, hw, 3)
        conv(f"layer1.{i}.conv3", planes, 4 * planes, hw, 1)
        if cin != 4 * planes:
            conv(f"layer1.{i}.downsample.0", cin, 4 * planes, hw, 1)
        cin = 4 * planes
    ch, heads = pose["branch_channels"], pose["num_heads"]
    sizes = [conv("transition1.0.0", cin, ch[0], hw, 3),
             conv("transition1.1.0.0", cin, ch[1], hw, 3, 2)]
    for s, n_mod in zip((2, 3, 4), pose["stage_modules"]):
        for m in range(n_mod):
            p = f"stage{s}.{m}"
            for br in range(s):
                for k in range(pose["stage_blocks"]):
                    items.extend(block_items(f"{p}.branches.{br}.{k}", n, ch[br], heads[br],
                                             sizes[br], pose["window_size"], pose["mlp_ratio"]))
            for i in range(1 if s == 4 and m == n_mod - 1 else s):
                for j in range(s):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f + ".0", ch[j], ch[i], sizes[j], 1)
                    at = sizes[j]
                    for k in range(i - j):
                        cout = ch[i] if k == i - j - 1 else ch[j]
                        at = conv(f"{f}.{k}.0", ch[j], ch[j], at, 3, 2, groups=ch[j])
                        conv(f"{f}.{k}.2", ch[j], cout, at, 1)
        if s < 4:
            sizes.append(conv(f"transition{s}.{s}.0.0", ch[s - 1], ch[s], sizes[-1], 3, 2))
    conv("final_layer", ch[0], pose["num_joints"], sizes[0], 1)
    return items


def frame_work(config):
    """Items of one frame (all of the rig's views) of stage A."""
    det, pose, rig = config["detector"], config["pose"], config["rig"]
    views, h, w = rig["views"], rig["height"], rig["width"]
    s, k = det["input_size"], det["max_candidates"]
    ph, pw = pose["input_size"]
    yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
    items = ops.conv_items(yspecs, nets.yolo_forward, (views, 3, s, s), "yolov3", set())
    items += hrformer_items(pose, views * k)
    items += [ops.matmul_item("resize rows", s, h, w * 3, views),
              ops.matmul_item("resize columns", s, w, s * 3, views),
              ops.matmul_item("crop rows", ph, h, w * 3, views * k),
              ops.matmul_item("crop columns", pw, w, ph * 3, views * k)]
    return items
