"""The reference's HRFormer: the published network written out in plain
PyTorch over a state_dict with mmpose's keys, in float32 with TF32 off,
and the weights drawn again from the run's weight seed.

HRFormer (Yuan et al., arXiv:2110.09408; mmpose's `mmpose/models/
backbones/hrformer.py`, `hrnet.py` and `TopdownHeatmapSimpleHead`, config
`hrformer_base_coco_384x288.py`): HRNet's stem, stage 1 and transitions,
then stages of modules whose branches hold pre-norm blocks of local 7x7
window attention with a relative position bias (the map zero-padded,
centred, to multiples of the window; no pad mask) and a conv FFN (1x1,
depthwise 3x3, 1x1, each with BN and exact erf GELU), joined by fuse
layers (a 1x1 conv + BN upsampled bilinearly from a coarser branch, chains
of depthwise 3x3 stride-2 conv + BN + 1x1 conv + BN from a finer one,
their sum through a ReLU), and a 1x1 heatmap layer on branch 0. Nothing
here comes from the program: the weights are drawn again (`make_weights`,
the same draws the program was handed, the detector's first), and the
forward is its own: BN in its eval form, unfolded; the padding, windows
and their inverse by pad, view and permute; the relative position index
as mmpose builds it; an explicit softmax with the bias; the bilinear
upsample written out; the crops in blocks of images. It is the copy of
`tests/plain_hrformer.py` that the benchmark carries, with the control.

The cell's control (`fp8=True`) rounds every linear's input and weight to
float8 e4m3 before its product, as fp8 inference does (`vitpose.to_fp8`: a
scale a token and an output channel): qkv and proj, and the FFN's fc1 and
fc2, linears over each pixel's channels; the precision below the
configuration's bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.pipeline import Reference, no_tf32
from benchmark.reference.vitpose import to_fp8

#: Standard deviations of the draws that depart from the published
#: initialization (`make_state_dict`), so that every term is live.
LINEAR_STD = 0.1
TABLE_STD = 1.0
HEAD_STD = 0.0002


def published_index(window):
    """mmpose `WindowMSA`'s relative_position_index, as it builds it."""
    def double_step_seq(step1, len1, step2, len2):
        seq1 = torch.arange(0, step1 * len1, step1)
        seq2 = torch.arange(0, step2 * len2, step2)
        return (seq1[:, None] + seq2[None, :]).reshape(1, -1)

    coords = double_step_seq(2 * window - 1, window, 1, window)
    return (coords + coords.T).flip(1).contiguous()


def state_dict_shapes(pose):
    """{key: (shape, role)} of the unfolded HRFormer state_dict, mmpose's
    keys in its module order; the last module computes branch 0's fuse row
    alone (the program's, and all the head reads)."""
    out = {}

    def conv(name, cout, cin, k, bias=False, groups=1, role="conv"):
        out[name + ".weight"] = ((cout, cin // groups, k, k), role)
        if bias:
            out[name + ".bias"] = ((cout,), "head_bias" if role == "head" else "bias")

    def bn(name, c, end=False):
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{field}"] = ((c,), "bn_" + field)
        if end:  # a fuse term's last BN
            out[name + ".weight"] = ((c,), "bn_weight_end")
        out[name + ".num_batches_tracked"] = ((), "count")

    def ln(name, c):
        out[name + ".weight"] = ((c,), "ln_weight")
        out[name + ".bias"] = ((c,), "bias")

    def lin(name, cout, cin):
        out[name + ".weight"] = ((cout, cin), "linear")
        out[name + ".bias"] = ((cout,), "bias")

    b, stem, planes = "backbone", pose["stem_channels"], pose["layer1_planes"]
    conv(b + ".conv1", stem, 3, 3)
    bn(b + ".bn1", stem)
    conv(b + ".conv2", stem, stem, 3)
    bn(b + ".bn2", stem)
    cin = stem
    for i in range(pose["layer1_blocks"]):
        p = f"{b}.layer1.{i}"
        conv(p + ".conv1", planes, cin, 1)
        bn(p + ".bn1", planes)
        conv(p + ".conv2", planes, planes, 3)
        bn(p + ".bn2", planes)
        conv(p + ".conv3", 4 * planes, planes, 1)
        bn(p + ".bn3", 4 * planes)
        if cin != 4 * planes:
            conv(p + ".downsample.0", 4 * planes, cin, 1)
            bn(p + ".downsample.1", 4 * planes)
        cin = 4 * planes
    ch, heads, ws = pose["branch_channels"], pose["num_heads"], pose["window_size"]
    conv(b + ".transition1.0.0", ch[0], cin, 3)
    bn(b + ".transition1.0.1", ch[0])
    conv(b + ".transition1.1.0.0", ch[1], cin, 3)
    bn(b + ".transition1.1.0.1", ch[1])
    for s, n_mod in zip((2, 3, 4), pose["stage_modules"]):
        for m in range(n_mod):
            p = f"{b}.stage{s}.{m}"
            for br in range(s):
                c = ch[br]
                for k in range(pose["stage_blocks"]):
                    q = f"{p}.branches.{br}.{k}"
                    ln(q + ".norm1", c)
                    out[q + ".attn.attn.relative_position_bias_table"] = (
                        ((2 * ws - 1) ** 2, heads[br]), "table")
                    out[q + ".attn.attn.relative_position_index"] = ((ws * ws, ws * ws), "index")
                    lin(q + ".attn.attn.qkv", 3 * c, c)
                    lin(q + ".attn.attn.proj", c, c)
                    ln(q + ".norm2", c)
                    hidden = c * pose["mlp_ratio"]
                    conv(q + ".ffn.fc1", hidden, c, 1, bias=True)
                    bn(q + ".ffn.norm1", hidden)
                    conv(q + ".ffn.dw3x3", hidden, hidden, 3, bias=True, groups=hidden)
                    bn(q + ".ffn.norm2", hidden)
                    conv(q + ".ffn.fc2", c, hidden, 1, bias=True)
                    bn(q + ".ffn.norm3", c)
            for i in range(1 if s == 4 and m == n_mod - 1 else s):
                for j in range(s):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f + ".0", ch[i], ch[j], 1)
                        bn(f + ".1", ch[i], end=True)
                    for k in range(i - j):
                        cout = ch[i] if k == i - j - 1 else ch[j]
                        conv(f"{f}.{k}.0", ch[j], ch[j], 3, groups=ch[j])
                        bn(f"{f}.{k}.1", ch[j])
                        conv(f"{f}.{k}.2", cout, ch[j], 1)
                        bn(f"{f}.{k}.3", cout, end=k == i - j - 1)
        if s < 4:
            conv(f"{b}.transition{s}.{s}.0.0", ch[s], ch[s - 1], 3)
            bn(f"{b}.transition{s}.{s}.0.1", ch[s])
    conv("keypoint_head.final_layer", pose["num_joints"], ch[0], 1, bias=True, role="head")
    return out


def make_state_dict(pose, generator, device):
    """The unfolded f32 HRFormer weights, drawn from `generator` on
    `device` in four calls: one uniform draw made truncated-normal (std
    LINEAR_STD, cut at 2 std, by the inverse CDF) for the linears' weights;
    one normal draw for the convs (He-normal, std sqrt(2 / fan_in), fan-in
    Cin / groups k^2; the heatmap layer N(0, HEAD_STD)); one normal draw for
    the vectors (conv and linear biases and LayerNorm shifts N(0, 0.02), BN
    shifts and means N(0, 0.05), the heatmap layer's bias N(0, 0.001), the
    relative position bias tables N(0, TABLE_STD)); one uniform draw for
    LayerNorm scales (0.9 to 1.1) and BN scales and variances (0.8 to 1.2;
    a fuse term's last BN scales by a tenth of that, as the HRNet
    reference's residual ends do, so that the sums of the fuse layers do
    not grow the activations geometrically from module to module).
    The relative position index is mmpose's. The same generator state
    gives the same weights on every call."""
    shapes = state_dict_shapes(pose)
    out = {}

    def draw(roles, fill):
        keys = [k for k, (_, role) in shapes.items() if role in roles]
        sizes = [math.prod(shapes[k][0]) for k in keys]
        flat = fill(sum(sizes))
        for key, v in zip(keys, flat.split(sizes)):
            out[key] = v.view(shapes[key][0])
        return keys

    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2

    def trunc(n):
        u = torch.empty(n, device=device).uniform_(lo, hi, generator=generator)
        return torch.erfinv(2 * u - 1).mul_(LINEAR_STD * math.sqrt(2))

    draw({"linear"}, trunc)

    def convs(n):
        flat = torch.empty(n, device=device).normal_(generator=generator)
        at = 0
        for shp, role in shapes.values():
            if role in ("conv", "head"):
                size = math.prod(shp)
                flat[at:at + size].mul_(HEAD_STD if role == "head"
                                        else math.sqrt(2.0 / (shp[1] * shp[2] * shp[3])))
                at += size
        return flat

    draw({"conv", "head"}, convs)
    vec = {"bias": 0.02, "bn_bias": 0.05, "bn_running_mean": 0.05, "head_bias": 0.001,
           "table": TABLE_STD}
    keys = draw(set(vec), lambda n: torch.empty(n, device=device).normal_(generator=generator))
    for key in keys:
        out[key].mul_(vec[shapes[key][1]])
    spans = {"ln_weight": (0.9, 0.2), "bn_weight": (0.8, 0.4), "bn_weight_end": (0.08, 0.04),
             "bn_running_var": (0.8, 0.4)}
    keys = draw(set(spans), lambda n: torch.empty(n, device=device).uniform_(
        generator=generator))
    for key in keys:
        lo_, width = spans[shapes[key][1]]
        out[key].mul_(width).add_(lo_)
    index = published_index(pose["window_size"]).to(device)
    for key, (_, role) in shapes.items():
        if role == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
        elif role == "index":
            out[key] = index.clone()
    return {k: out[k] for k in shapes}


def make_weights(config, weight_seed, device):
    """The unfolded state_dicts of the detector and HRFormer, in that order
    from one generator: what the program is handed."""
    det = config["detector"]
    gen = torch.Generator(device=device).manual_seed(weight_seed)
    ysd = nets.make_state_dict(nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0)),
                               gen, device)
    return ysd, make_state_dict(config["pose"], gen, device)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def upsample_bilinear(x, factor):
    """(N, C, H, W) -> (N, C, H f, W f), align_corners False: each output
    coordinate's source (o + 0.5) / f - 0.5, clamped at 0, read between its
    two neighbours (the last one repeated at the edge)."""
    def axis(n_in):
        src = ((torch.arange(n_in * factor, dtype=torch.float32, device=x.device) + 0.5)
               / factor - 0.5).clamp(min=0)
        i0 = src.floor().long().clamp(max=n_in - 1)
        return i0, (i0 + 1).clamp(max=n_in - 1), src - i0

    r0, r1, lr = axis(x.shape[2])
    x = x[:, :, r0] * (1 - lr)[:, None] + x[:, :, r1] * lr[:, None]
    c0, c1, lc = axis(x.shape[3])
    return x[..., c0] * (1 - lc) + x[..., c1] * lc


class HRFormerNet:
    """The forward over an unfolded f32 state_dict (float tensors)."""

    def __init__(self, sd, pose, fp8=False):
        self.sd, self.heads, self.window = sd, pose["num_heads"], pose["window_size"]
        self.ln_eps, self.fp8 = pose["ln_eps"], fp8

    def conv(self, x, name, stride=1, groups=1):
        w = self.sd[name + ".weight"]
        return F.conv2d(x, w, self.sd.get(name + ".bias"), stride, w.shape[-1] // 2,
                        groups=groups)

    def bn(self, x, name):
        sd = self.sd
        scale = sd[name + ".weight"] / torch.sqrt(sd[name + ".running_var"] + nets.BN_EPS)
        return (x - sd[name + ".running_mean"][:, None, None]) * scale[:, None, None] \
            + sd[name + ".bias"][:, None, None]

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.sd[name + ".weight"], self.sd[name + ".bias"],
                            self.ln_eps)

    def lin(self, x, name):
        w = self.sd[name + ".weight"]
        if self.fp8:
            x, w = to_fp8(x), to_fp8(w)
        return x @ w.t() + self.sd[name + ".bias"]

    def pointwise(self, x, name):
        """A 1x1 conv (the FFN's fc1 and fc2), a linear over each pixel's
        channels: under the control in fp8, as `lin`."""
        if not self.fp8:
            return self.conv(x, name)
        w = self.sd[name + ".weight"]
        x = to_fp8(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        w = to_fp8(w.flatten(1)).view(w.shape)
        return F.conv2d(x, w, self.sd[name + ".bias"])

    def window_msa(self, u, p, heads):
        b, t, c = u.shape
        d = c // heads
        q, k, v = self.lin(u, p + ".qkv").reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        table = self.sd[p + ".relative_position_bias_table"]
        index = published_index(self.window).to(table.device)
        bias = table[index.view(-1)].view(t, t, heads).permute(2, 0, 1)
        s = (q * d ** -0.5) @ k.transpose(-2, -1) + bias
        s = torch.exp(s - s.amax(-1, keepdim=True))
        o = ((s / s.sum(-1, keepdim=True)) @ v).transpose(1, 2).reshape(b, t, c)
        return self.lin(o, p + ".proj")

    def local_attn(self, u, h, w, p, heads):
        n, _, c = u.shape
        ws = self.window
        ph, pw = -h % ws, -w % ws
        u = F.pad(u.view(n, h, w, c), (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        hp, wp = h + ph, w + pw
        u = u.view(n, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        a = self.window_msa(u.reshape(-1, ws * ws, c), p, heads)
        a = a.view(n, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        a = a.reshape(n, hp, wp, c)[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        return a.reshape(n, h * w, c)

    def block(self, x, p, heads):
        n, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + self.local_attn(self.ln(t, p + ".norm1"), h, w, p + ".attn.attn", heads)
        u = self.ln(t, p + ".norm2").transpose(1, 2).reshape(n, c, h, w)
        f = p + ".ffn"
        u = gelu(self.bn(self.pointwise(u, f + ".fc1"), f + ".norm1"))
        u = gelu(self.bn(self.conv(u, f + ".dw3x3", groups=u.shape[1]), f + ".norm2"))
        u = gelu(self.bn(self.pointwise(u, f + ".fc2"), f + ".norm3"))
        return t.transpose(1, 2).reshape(n, c, h, w) + u

    def bottleneck(self, x, p):
        y = torch.relu(self.bn(self.conv(x, p + ".conv1"), p + ".bn1"))
        y = torch.relu(self.bn(self.conv(y, p + ".conv2"), p + ".bn2"))
        y = self.bn(self.conv(y, p + ".conv3"), p + ".bn3")
        if p + ".downsample.0.weight" in self.sd:
            x = self.bn(self.conv(x, p + ".downsample.0"), p + ".downsample.1")
        return torch.relu(x + y)

    def module(self, xs, p):
        ys = []
        for b, x in enumerate(xs):
            i = 0
            while f"{p}.branches.{b}.{i}.norm1.weight" in self.sd:
                x = self.block(x, f"{p}.branches.{b}.{i}", self.heads[b])
                i += 1
            ys.append(x)
        outs = []
        for i in range(len(ys)):
            if not any(k.startswith(f"{p}.fuse_layers.{i}.") for k in self.sd):
                break
            y = 0
            for j, yj in enumerate(ys):
                if j == i:
                    y = y + yj
                elif j > i:
                    q = f"{p}.fuse_layers.{i}.{j}"
                    y = y + upsample_bilinear(self.bn(self.conv(yj, q + ".0"), q + ".1"),
                                              2 ** (j - i))
                else:
                    for k in range(i - j):
                        q = f"{p}.fuse_layers.{i}.{j}.{k}"
                        yj = self.bn(self.conv(yj, q + ".0", 2, yj.shape[1]), q + ".1")
                        yj = self.bn(self.conv(yj, q + ".2"), q + ".3")
                        if k < i - j - 1:
                            yj = torch.relu(yj)
                    y = y + yj
            outs.append(torch.relu(y))
        return outs

    def forward(self, x):
        b = "backbone"
        x = torch.relu(self.bn(self.conv(x, b + ".conv1", 2), b + ".bn1"))
        x = torch.relu(self.bn(self.conv(x, b + ".conv2", 2), b + ".bn2"))
        i = 0
        while f"{b}.layer1.{i}.conv1.weight" in self.sd:
            x = self.bottleneck(x, f"{b}.layer1.{i}")
            i += 1

        def trans(x, q, stride):
            return torch.relu(self.bn(self.conv(x, q + ".0", stride), q + ".1"))

        xs = [trans(x, b + ".transition1.0", 1), trans(x, b + ".transition1.1.0", 2)]
        for s in (2, 3, 4):
            m = 0
            while f"{b}.stage{s}.{m}.branches.0.0.norm1.weight" in self.sd:
                xs = self.module(xs, f"{b}.stage{s}.{m}")
                m += 1
            if s < 4:
                xs = xs + [trans(xs[-1], f"{b}.transition{s}.{s}.0", 2)]
        return self.conv(xs[0], "keypoint_head.final_layer")


def hrformer_forward(sd, x, pose, fp8=False):
    """(N, 3, H, W) normalized crops -> (N, J, H/4, W/4) heatmaps in f32."""
    return HRFormerNet(sd, pose, fp8).forward(x)


class HRFormerReference(Reference):
    """Stage A of an HRFormer configuration: YOLOv3 as `Reference` has it,
    HRFormer in float32 (or its fp8 control) over the crops, in blocks of
    `block` images; `judge.stage_a_numbers` takes it as it takes
    `Reference`."""

    def __init__(self, config, weight_seed, device, fp8=False, block=8):
        self.cfg, self.block, self.fp8 = config, block, fp8
        det = config["detector"]
        self.yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
        ysd, hsd = make_weights(config, weight_seed, device)
        self.hsd = {k: v for k, v in hsd.items() if v.is_floating_point()}
        self.yfold = nets.fold(self.yspecs, ysd)
        del ysd, hsd
        self.yconv = nets.float_conv(self.yspecs, self.yfold)

    def heatmaps(self, images, boxes):
        """(N * K, J, h, w) heatmaps of the crops at `boxes`, and their boxes."""
        outs, eb = [], []
        with torch.no_grad(), no_tf32():
            for i in range(0, len(images), self.block):
                c, e = self.crops(images[i:i + self.block], boxes[i:i + self.block])
                outs.append(hrformer_forward(self.hsd, c, self.cfg["pose"], self.fp8))
                eb.append(e)
        return torch.cat(outs), torch.cat(eb)
