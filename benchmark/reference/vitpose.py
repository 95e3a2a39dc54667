"""The reference's ViTPose: the published network written out in plain
PyTorch over a state_dict with the official keys, in float32 with TF32
off, and the weights drawn again from the run's weight seed.

ViTPose (Xu et al., arXiv:2204.12484; the official `mmpose/models/
backbones/vit.py` and `TopdownHeatmapSimpleHead`): a 16x16 patch conv
(stride 16, padding 2), a learned position embedding (its first row added
to every token, there being no class token), `depth` pre-norm blocks of
multi-head softmax attention and a GELU MLP, a last LayerNorm, and a head
of two stride-2 4x4 transposed convs with BN and ReLU and a 1x1 conv.
Nothing here comes from the program: the weights are drawn again
(`make_weights`, the same draws the program was handed, the detector's
first), and the forward is its own: an explicit softmax, exact erf GELU,
the BN in its eval form, no folding, the crops in blocks of images.

The cell's control (`fp8=True`) rounds every ViT linear's input and weight
to float8 e4m3 before its product, as fp8 inference does (a scale a token
row and an output channel, each row's largest magnitude mapped to e4m3's
largest finite value, 448): the precision below the configuration's bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.pipeline import Reference, no_tf32

FP8_MAX = 448.0


def tokens_of(pose):
    """(h, w) of the token grid of a crop: the patch conv's output size."""
    p, pad = pose["patch_size"], pose["patch_padding"]
    return tuple((s + 2 * pad - p) // p + 1 for s in pose["input_size"])


def state_dict_shapes(pose):
    """{key: (shape, role)} of the unfolded ViTPose state_dict, the
    official keys in the official module order."""
    c, p = pose["embed_dim"], pose["patch_size"]
    hidden = c * pose["mlp_ratio"]
    h, w = pose["input_size"]
    n_pos = (h // p) * (w // p) + 1
    out = {"backbone.pos_embed": ((1, n_pos, c), "trunc"),
           "backbone.patch_embed.proj.weight": ((c, 3, p, p), "conv"),
           "backbone.patch_embed.proj.bias": ((c,), "bias")}
    for i in range(pose["depth"]):
        b = f"backbone.blocks.{i}"
        for name, (cout, cin) in (("norm1", (c, 0)), ("attn.qkv", (3 * c, c)),
                                  ("attn.proj", (c, c)), ("norm2", (c, 0)),
                                  ("mlp.fc1", (hidden, c)), ("mlp.fc2", (c, hidden))):
            if cin:
                out[f"{b}.{name}.weight"] = ((cout, cin), "trunc")
                out[f"{b}.{name}.bias"] = ((cout,), "bias")
            else:
                out[f"{b}.{name}.weight"] = ((cout,), "ln_weight")
                out[f"{b}.{name}.bias"] = ((cout,), "bias")
    out["backbone.last_norm.weight"] = ((c,), "ln_weight")
    out["backbone.last_norm.bias"] = ((c,), "bias")
    cin, k = c, pose["deconv_kernel"]
    for j, planes in enumerate(pose["deconv_filters"]):
        out[f"keypoint_head.deconv_layers.{3 * j}.weight"] = ((cin, planes, k, k), "deconv")
        bn = f"keypoint_head.deconv_layers.{3 * j + 1}"
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{field}"] = ((planes,), "bn_" + field)
        out[f"{bn}.num_batches_tracked"] = ((), "count")
        cin = planes
    out["keypoint_head.final_layer.weight"] = ((pose["num_joints"], cin, 1, 1), "head")
    out["keypoint_head.final_layer.bias"] = ((pose["num_joints"],), "head_bias")
    return out


def make_state_dict(pose, generator, device):
    """The unfolded f32 ViTPose weights, drawn from `generator` on
    `device` in four calls: one uniform draw made truncated-normal (std
    0.02, cut at 2 std, by the inverse CDF) for the linears' weights and
    the position embedding; one normal draw for the convs (the patch
    embedding and the transposed convs He-normal, std sqrt(2 / fan_in), a
    transposed conv's fan-in being the inputs that reach one output,
    Cin k^2 / 4; the heatmap layer N(0, 0.001), the published head's init);
    one normal draw for the vectors (linear biases and LayerNorm shifts
    N(0, 0.02), BN shifts and means N(0, 0.05), the heatmap layer's bias
    N(0, 0.001)); one uniform draw for LayerNorm scales (0.9 to 1.1) and BN
    scales and variances (0.8 to 1.2). The same generator state gives the
    same weights on every call.

    The heatmap layer's scale keeps the maps' peaks (the keypoints'
    scores) near 0.04, under the tracker's 0.5 belief gate, as the
    HRNet configurations' random weights do: the tracker makes no tracks
    of random networks' keypoints, and the clip check holds that it
    invents none."""
    shapes = state_dict_shapes(pose)
    out = {}

    def draw(role_keys, fill):
        keys = [k for k, (_, role) in shapes.items() if role in role_keys]
        sizes = [math.prod(shapes[k][0]) for k in keys]
        flat = fill(sum(sizes))
        for key, v in zip(keys, flat.split(sizes)):
            out[key] = v.view(shapes[key][0])
        return keys

    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2

    def trunc(n):
        u = torch.empty(n, device=device).uniform_(lo, hi, generator=generator)
        return torch.erfinv(2 * u - 1).mul_(0.02 * math.sqrt(2))

    draw({"trunc"}, trunc)

    def convs(n):
        flat = torch.empty(n, device=device).normal_(generator=generator)
        at = 0
        for shp, role in shapes.values():
            if role not in ("conv", "deconv", "head"):
                continue
            if role == "head":
                std = 0.001
            else:  # He-normal; Cin k^2 / 4 inputs reach an output of a stride-2 transposed conv
                fan_in = shp[1] * shp[2] * shp[3] if role == "conv" else shp[0] * shp[2] * shp[3] / 4
                std = math.sqrt(2.0 / fan_in)
            size = math.prod(shp)
            flat[at:at + size].mul_(std)
            at += size
        return flat

    draw({"conv", "deconv", "head"}, convs)
    vec = {"bias": 0.02, "bn_bias": 0.05, "bn_running_mean": 0.05, "head_bias": 0.001}
    keys = draw(set(vec), lambda n: torch.empty(n, device=device).normal_(generator=generator))
    for key in keys:
        out[key].mul_(vec[shapes[key][1]])
    spans = {"ln_weight": (0.9, 0.2), "bn_weight": (0.8, 0.4), "bn_running_var": (0.8, 0.4)}
    keys = draw(set(spans), lambda n: torch.empty(n, device=device).uniform_(
        generator=generator))
    for key in keys:
        lo_, width = spans[shapes[key][1]]
        out[key].mul_(width).add_(lo_)
    for key, (_, role) in shapes.items():
        if role == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
    return {k: out[k] for k in shapes}


def make_weights(config, weight_seed, device):
    """The unfolded state_dicts of the detector and ViTPose, in that order
    from one generator: what the program is handed."""
    det = config["detector"]
    gen = torch.Generator(device=device).manual_seed(weight_seed)
    ysd = nets.make_state_dict(nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0)),
                               gen, device)
    return ysd, make_state_dict(config["pose"], gen, device)


def to_fp8(t):
    """t rounded to float8 e4m3 with a scale a row (the last dimension's
    largest magnitude to 448), back in float32."""
    scale = t.abs().amax(-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def vit_forward(sd, x, pose, fp8=False):
    """(N, 3, H, W) normalized crops -> (N, J, H/4, W/4) heatmaps in f32."""
    eps, heads = pose["ln_eps"], pose["num_heads"]

    def lin(t, name):
        w, b = sd[name + ".weight"], sd[name + ".bias"]
        if fp8:
            t, w = to_fp8(t), to_fp8(w)
        return t @ w.t() + b

    def ln(t, name):
        return F.layer_norm(t, t.shape[-1:], sd[name + ".weight"], sd[name + ".bias"], eps)

    p = pose["patch_size"]
    x = F.conv2d(x, sd["backbone.patch_embed.proj.weight"], sd["backbone.patch_embed.proj.bias"],
                 stride=p, padding=pose["patch_padding"])
    n, c, hp, wp = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = sd["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    d = c // heads
    for i in range(pose["depth"]):
        b = f"backbone.blocks.{i}"
        qkv = lin(ln(x, b + ".norm1"), b + ".attn.qkv").reshape(n, -1, 3, heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-2, -1)) * d ** -0.5
        s = torch.exp(s - s.amax(-1, keepdim=True))
        o = ((s / s.sum(-1, keepdim=True)) @ v).transpose(1, 2).reshape(n, -1, c)
        x = x + lin(o, b + ".attn.proj")
        h = lin(ln(x, b + ".norm2"), b + ".mlp.fc1")
        x = x + lin(0.5 * h * (1 + torch.erf(h / math.sqrt(2))), b + ".mlp.fc2")
    x = ln(x, "backbone.last_norm").transpose(1, 2).reshape(n, c, hp, wp)
    k = pose["deconv_kernel"]
    for j in range(len(pose["deconv_filters"])):
        dc, bn = f"keypoint_head.deconv_layers.{3 * j}", f"keypoint_head.deconv_layers.{3 * j + 1}"
        x = F.conv_transpose2d(x, sd[dc + ".weight"], None, stride=2, padding=(k - 2) // 2)
        g = sd[bn + ".weight"] / torch.sqrt(sd[bn + ".running_var"] + nets.BN_EPS)
        x = (x - sd[bn + ".running_mean"][:, None, None]) * g[:, None, None] \
            + sd[bn + ".bias"][:, None, None]
        x = torch.relu(x)
    return F.conv2d(x, sd["keypoint_head.final_layer.weight"], sd["keypoint_head.final_layer.bias"])


class ViTReference(Reference):
    """Stage A of a ViTPose configuration: YOLOv3 as `Reference` has it,
    ViTPose in float32 (or its fp8 control) over the crops, in blocks of
    `block` images; `judge.stage_a_numbers` takes it as it takes
    `Reference`."""

    def __init__(self, config, weight_seed, device, fp8=False, block=8):
        self.cfg, self.block, self.fp8 = config, block, fp8
        det = config["detector"]
        self.yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
        ysd, self.vsd = make_weights(config, weight_seed, device)
        self.yfold = nets.fold(self.yspecs, ysd)
        del ysd
        self.yconv = nets.float_conv(self.yspecs, self.yfold)

    def heatmaps(self, images, boxes):
        """(N * K, J, h, w) heatmaps of the crops at `boxes`, and their boxes."""
        outs, eb = [], []
        with torch.no_grad(), no_tf32():
            for i in range(0, len(images), self.block):
                c, e = self.crops(images[i:i + self.block], boxes[i:i + self.block])
                outs.append(vit_forward(self.vsd, c, self.cfg["pose"], self.fp8))
                eb.append(e)
        return torch.cat(outs), torch.cat(eb)
