"""The operations and bytes of one frame of stage A, from the cell's
shapes, traced on the meta device through the benchmark's own copy of the
networks (`benchmark/reference/nets.py`). It counts the work the
algorithm needs, whatever implements it.

A conv's operations are 2 x N x Cout x Hout x Wout x Cin x k x k; its
bytes are its input, weights and output each counted once (activations
in bf16, weights in bf16, or in int8 where the conv is quantized). The
preprocessing's resamples are two matrix products an image or crop
(`reference/stage_a.py`), counted as dense products in bf16.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.nn.functional as F

from benchmark.reference import nets

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks_for(device_kind):
    """The published peaks of the card named `device_kind`, or None."""
    return next((p for p in PEAKS["cards"] if p["match"] in device_kind), None)


def conv_items(specs, forward, x_shape, net, quantized, **kwargs):
    """One item per conv call of `forward` on a meta input of `x_shape`."""
    items = []
    stride = {s.name: s.stride for s in specs}
    cout = {s.name: (s.cout, s.cin, s.k) for s in specs}

    def conv(name, x):
        co, ci, k = cout[name]
        w = torch.empty((co, ci, k, k), device="meta")
        y = F.conv2d(x, w, None, stride[name], k // 2)
        n, _, ho, wo = y.shape
        q = name in quantized
        items.append({
            "kind": "conv", "net": net, "name": name, "precision": "int8" if q else "bf16",
            "ops": 2 * n * co * ho * wo * ci * k * k,
            "bytes": 2 * x.numel() + (1 if q else 2) * w.numel() + 2 * y.numel()})
        return y

    forward(conv, torch.empty(x_shape, device="meta"), **kwargs)
    return items


def matmul_item(name, m, k, n, batch):
    return {"kind": "matmul", "net": "preprocess", "name": name, "precision": "bf16",
            "ops": 2 * batch * m * k * n, "bytes": 2 * batch * (m * k + k * n + m * n)}


def frame_work(config):
    """Items of one frame (all of the rig's views) of stage A."""
    det, pose, rig = config["detector"], config["pose"], config["rig"]
    views, h, w = rig["views"], rig["height"], rig["width"]
    s, k = det["input_size"], det["max_candidates"]
    ph, pw = pose["input_size"]
    int8 = config["precision"] == "int8"
    yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
    hspecs = nets.hrnet_specs(**nets.hrnet_kwargs(pose))
    yq = {sp.name for sp in yspecs if sp.bn is not None} if int8 else set()
    hq = {sp.name for sp in hspecs if sp.name != "final_layer"} if int8 else set()
    items = conv_items(yspecs, nets.yolo_forward, (views, 3, s, s), "yolov3", yq)
    items += conv_items(hspecs, nets.hrnet_forward, (views * k, 3, ph, pw), "hrnet", hq,
                        **nets.hrnet_forward_kwargs(pose))
    items += [matmul_item("resize rows", s, h, w * 3, views),
              matmul_item("resize columns", s, w, s * 3, views),
              matmul_item("crop rows", ph, h, w * 3, views * k),
              matmul_item("crop columns", pw, w, ph * 3, views * k)]
    return items


def bound_s(item, peaks):
    """The least time the card could take for one item: its operations at
    the peak of its precision or its bytes at the memory's peak."""
    rate = peaks["int8_ops"] if item["precision"] == "int8" else peaks["bf16_flops"]
    return max(item["ops"] / rate, item["bytes"] / peaks["bytes_per_s"])
