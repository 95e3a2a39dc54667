"""Plain PyTorch YOLOv3 and HRNet: the benchmark's own copy of the two
networks, for the reference that decides `correct` and for the operation
count (`benchmark/count`).

Written from the published architectures (darknet's yolov3.cfg, the
official `pose_hrnet` with its state_dict keys), not imported from the
program. A network is a list of `ConvSpec`s and a forward over a conv
callable `conv(name, x)`, so one forward serves the f32 reference, the
int8 and int4 references (`quant.py`) and the count on the meta device.
Activations are NCHW; the reference computes in float32 with TF32 off.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str          # the folded conv's key prefix ("conv3.conv", "stage2.0.fuse_layers.0.1.0")
    cin: int
    cout: int
    k: int
    stride: int
    bn: str | None     # key prefix of the BN folded into it, None for a biased conv
    residual_end: bool = False  # the last conv of a residual branch


# -- YOLOv3 -----------------------------------------------------------------

def yolo_layers(num_classes=80, width_mult=1.0):
    """(cout, k, stride, bn, ends a residual branch) in darknet cfg order, conv0 .. conv74; a
    `width_mult` other than 1 scales the BN convs' widths (test sizes)."""
    spec = []

    def conv(ch, k, s, bn=True, end=False):
        spec.append((max(int(ch * width_mult), 1) if bn else ch, k, s, bn, end))

    def res(ch, n):
        for _ in range(n):
            conv(ch // 2, 1, 1)
            conv(ch, 3, 1, end=True)

    head = 3 * (5 + num_classes)
    conv(32, 3, 1)
    conv(64, 3, 2); res(64, 1)
    conv(128, 3, 2); res(128, 2)
    conv(256, 3, 2); res(256, 8)
    conv(512, 3, 2); res(512, 8)
    conv(1024, 3, 2); res(1024, 4)
    for ch, k in ((512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)):
        conv(ch, k, 1)
    conv(head, 1, 1, False)          # conv58, stride 32
    conv(256, 1, 1)                  # conv59, upsampled
    for ch, k in ((256, 1), (512, 3), (256, 1), (512, 3), (256, 1), (512, 3)):
        conv(ch, k, 1)
    conv(head, 1, 1, False)          # conv66, stride 16
    conv(128, 1, 1)                  # conv67, upsampled
    for ch, k in ((128, 1), (256, 3), (128, 1), (256, 3), (128, 1), (256, 3)):
        conv(ch, k, 1)
    conv(head, 1, 1, False)          # conv74, stride 8
    return spec


YOLO_HEADS = (58, 66, 74)


def yolo_specs(num_classes=80, width_mult=1.0):
    layers = yolo_layers(num_classes, width_mult)
    out, cin = [], 3
    for i, (cout, k, s, bn, end) in enumerate(layers):
        if i == 60:
            cin = layers[59][0] + layers[42][0]
        elif i == 68:
            cin = layers[67][0] + layers[25][0]
        out.append(ConvSpec(f"conv{i}.conv", cin, cout, k, s, f"conv{i}.bn" if bn else None, end))
        cin = cout
        if i == 58:
            cin = layers[56][0]
        elif i == 66:
            cin = layers[64][0]
    return out


def yolo_forward(conv, x):
    """(N, 3, S, S) in [0, 1] -> three raw heads (strides 32, 16, 8)."""
    def run(i, x):
        y = conv(f"conv{i}.conv", x)
        return y if i in YOLO_HEADS else F.leaky_relu(y, 0.1)

    def res(x, i, n):
        for _ in range(n):
            x = x + run(i + 1, run(i, x))
            i += 2
        return x, i

    x = run(0, x)
    x = run(1, x); x, i = res(x, 2, 1)
    x = run(i, x); x, i = res(x, i + 1, 2)
    x = run(i, x); x, i = res(x, i + 1, 8)
    route25 = x
    x = run(i, x); x, i = res(x, i + 1, 8)
    route42 = x
    x = run(i, x); x, i = res(x, i + 1, 4)
    for j in range(52, 57):
        x = run(j, x)
    det1 = run(58, run(57, x))
    x = torch.cat([F.interpolate(run(59, x), scale_factor=2, mode="nearest"), route42], 1)
    for j in range(60, 65):
        x = run(j, x)
    det2 = run(66, run(65, x))
    x = torch.cat([F.interpolate(run(67, x), scale_factor=2, mode="nearest"), route25], 1)
    for j in range(68, 73):
        x = run(j, x)
    det3 = run(74, run(73, x))
    return [det1, det2, det3]


# -- HRNet (pose_hrnet) --------------------------------------------------------

def hrnet_specs(width=48, num_joints=17, stem=64, layer1_blocks=4, planes=64,
                stage_modules=(1, 4, 3), stage_blocks=4):
    """Every conv of pose_hrnet with its official key prefix."""
    out = []

    def conv(name, cin, cout, k, s=1, bn=None):
        # the last conv of a bottleneck (layer1) or of a basic block (branches)
        end = name.endswith(".conv3") or (".branches." in name and name.endswith(".conv2"))
        out.append(ConvSpec(name, cin, cout, k, s, bn, end))

    w = (width, 2 * width, 4 * width, 8 * width)
    conv("conv1", 3, stem, 3, 2, "bn1")
    conv("conv2", stem, stem, 3, 2, "bn2")
    cin = stem
    for b in range(layer1_blocks):
        p = f"layer1.{b}"
        conv(f"{p}.conv1", cin, planes, 1, bn=f"{p}.bn1")
        conv(f"{p}.conv2", planes, planes, 3, bn=f"{p}.bn2")
        conv(f"{p}.conv3", planes, 4 * planes, 1, bn=f"{p}.bn3")
        if cin != 4 * planes:
            conv(f"{p}.downsample.0", cin, 4 * planes, 1, bn=f"{p}.downsample.1")
        cin = 4 * planes
    conv("transition1.0.0", cin, w[0], 3, bn="transition1.0.1")
    conv("transition1.1.0.0", cin, w[1], 3, 2, "transition1.1.0.1")
    for s, (n_mod, n_br) in enumerate(zip(stage_modules, (2, 3, 4))):
        stage = s + 2
        if stage > 2:
            conv(f"transition{stage - 1}.{n_br - 1}.0.0", w[n_br - 2], w[n_br - 1], 3, 2,
                 f"transition{stage - 1}.{n_br - 1}.0.1")
        for m in range(n_mod):
            p = f"stage{stage}.{m}"
            for b in range(n_br):
                for blk in range(stage_blocks):
                    q = f"{p}.branches.{b}.{blk}"
                    conv(f"{q}.conv1", w[b], w[b], 3, bn=f"{q}.bn1")
                    conv(f"{q}.conv2", w[b], w[b], 3, bn=f"{q}.bn2")
            outs = 1 if (s == len(stage_modules) - 1 and m == n_mod - 1) else n_br
            for i in range(outs):
                for j in range(n_br):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f"{f}.0", w[j], w[i], 1, bn=f"{f}.1")
                    elif j < i:
                        for k in range(i - j):
                            last = k == i - j - 1
                            conv(f"{f}.{k}.0", w[j], w[i] if last else w[j], 3, 2, f"{f}.{k}.1")
    conv("final_layer", w[0], num_joints, 1)
    return out


def hrnet_forward(conv, x, width=48, layer1_blocks=4, stage_modules=(1, 4, 3),
                  stage_blocks=4):
    """(N, 3, H, W) normalized crops -> (N, J, H/4, W/4) heatmaps."""
    x = F.relu(conv("conv1", x))
    x = F.relu(conv("conv2", x))
    for b in range(layer1_blocks):
        p = f"layer1.{b}"
        y = F.relu(conv(f"{p}.conv1", x))
        y = F.relu(conv(f"{p}.conv2", y))
        y = conv(f"{p}.conv3", y)
        skip = conv(f"{p}.downsample.0", x) if b == 0 else x
        x = F.relu(y + skip)
    xs = [F.relu(conv("transition1.0.0", x)), F.relu(conv("transition1.1.0.0", x))]
    for s, (n_mod, n_br) in enumerate(zip(stage_modules, (2, 3, 4))):
        stage = s + 2
        if stage > 2:
            xs = xs + [F.relu(conv(f"transition{stage - 1}.{n_br - 1}.0.0", xs[-1]))]
        for m in range(n_mod):
            p = f"stage{stage}.{m}"
            ys = []
            for b in range(n_br):
                y = xs[b]
                for blk in range(stage_blocks):
                    q = f"{p}.branches.{b}.{blk}"
                    z = F.relu(conv(f"{q}.conv1", y))
                    y = F.relu(conv(f"{q}.conv2", z) + y)
                ys.append(y)
            outs = 1 if (s == len(stage_modules) - 1 and m == n_mod - 1) else n_br
            new = []
            for i in range(outs):
                acc = None
                for j in range(n_br):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j == i:
                        y = ys[j]
                    elif j > i:
                        y = F.interpolate(conv(f"{f}.0", ys[j]), scale_factor=2 ** (j - i),
                                          mode="nearest")
                    else:
                        y = ys[j]
                        for k in range(i - j):
                            y = conv(f"{f}.{k}.0", y)
                            if k != i - j - 1:
                                y = F.relu(y)
                    acc = y if acc is None else acc + y
                new.append(F.relu(acc))
            xs = new
    return conv("final_layer", xs[0])


def hrnet_kwargs(pose):
    """`hrnet_specs` keywords from a configuration's "pose" group."""
    return dict(width=pose["width"], num_joints=pose["num_joints"],
                stem=pose["stem_channels"], layer1_blocks=pose["layer1_blocks"],
                planes=pose["layer1_planes"], stage_modules=tuple(pose["stage_modules"]),
                stage_blocks=pose["stage_blocks"])


def hrnet_forward_kwargs(pose):
    """`hrnet_forward` keywords from a configuration's "pose" group."""
    return dict(width=pose["width"], layer1_blocks=pose["layer1_blocks"],
                stage_modules=tuple(pose["stage_modules"]), stage_blocks=pose["stage_blocks"])


# -- weights -------------------------------------------------------------------

def state_dict_shapes(specs):
    """{key: (shape, role)} of the unfolded state_dict: He-normal conv
    weights, the BNs' four vectors and counter, and the biases of the
    convs without BN."""
    out = {}
    for s in specs:
        out[f"{s.name}.weight"] = ((s.cout, s.cin, s.k, s.k), "conv")
        if s.bn is None:
            out[f"{s.name}.bias"] = ((s.cout,), "bias")
        else:
            for field in ("weight", "bias", "running_mean", "running_var"):
                role = "bn_" + field
                out[f"{s.bn}.{field}"] = ((s.cout,), role + "_end" if s.residual_end and
                                          field == "weight" else role)
            out[f"{s.bn}.num_batches_tracked"] = ((), "count")
    return out


def make_state_dict(specs, generator, device):
    """The unfolded f32 weights of a network, drawn from `generator` on
    `device` in three calls: one normal draw for every conv weight (scaled
    to He-normal, std sqrt(2 / fan_in)), one for the biases and BN shifts,
    one uniform draw for the BN scales and variances. The BN that ends a
    residual branch scales by a tenth of the others (the small last-BN
    scale of residual networks' initialization), so that activations keep
    their size through the residual adds and the detector's heads give
    scores and boxes of a detector's range, not saturated ones. The same
    generator state gives the same weights on every call."""
    shapes = state_dict_shapes(specs)
    convs = [(k, shp) for k, (shp, role) in shapes.items() if role == "conv"]
    sizes = [int(torch.Size(shp).numel()) for _, shp in convs]
    flat = torch.empty(sum(sizes), device=device).normal_(generator=generator)
    std = torch.tensor([(2.0 / (shp[1] * shp[2] * shp[3])) ** 0.5 for _, shp in convs],
                       device=device)
    flat.mul_(torch.repeat_interleave(std, torch.tensor(sizes, device=device)))
    out = {k: v.view(shp) for (k, shp), v in zip(convs, flat.split(sizes))}
    vecs = [(k, shp[0], role) for k, (shp, role) in shapes.items()
            if role not in ("conv", "count")]
    n = sum(c for _, c, _ in vecs)
    normal = torch.empty(n, device=device).normal_(generator=generator)
    uniform = torch.empty(n, device=device).uniform_(generator=generator)
    at = 0
    for key, c, role in vecs:
        z, u = normal[at:at + c], uniform[at:at + c]
        at += c
        out[key] = {"bn_weight": 0.8 + 0.4 * u, "bn_weight_end": 0.08 + 0.04 * u,
                    "bn_running_var": 0.8 + 0.4 * u,
                    "bn_bias": 0.05 * z, "bn_running_mean": 0.05 * z,
                    "bias": 0.1 * z}[role].clone()
    for key, (shp, role) in shapes.items():
        if role == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def fold(specs, sd):
    """{conv name: (weight, bias)} in f32 with every BN folded into its
    conv: w' = w * s, b' = beta - mean * s, s = gamma / sqrt(var + eps)."""
    out = {}
    for s in specs:
        w = sd[f"{s.name}.weight"].float()
        if s.bn is None:
            out[s.name] = (w, sd[f"{s.name}.bias"].float())
            continue
        g = sd[f"{s.bn}.weight"].float() * torch.rsqrt(sd[f"{s.bn}.running_var"].float() + BN_EPS)
        b = sd[f"{s.bn}.bias"].float() - sd[f"{s.bn}.running_mean"].float() * g
        out[s.name] = (w * g[:, None, None, None], b)
    return out


def float_conv(specs, folded):
    """conv(name, x): the f32 conv with its folded bias, padding k // 2."""
    stride = {s.name: s.stride for s in specs}

    def conv(name, x):
        w, b = folded[name]
        return F.conv2d(x, w, b, stride[name], w.shape[-1] // 2)

    return conv
