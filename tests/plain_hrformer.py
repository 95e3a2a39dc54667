"""The plain HRFormer forward: the published equations written out in
float32 over a state_dict with mmpose's keys (`backbone.*`,
`keypoint_head.final_layer.*`; Yuan et al., arXiv:2110.09408, mmpose's
`mmpose/models/backbones/hrformer.py`, `hrnet.py` and
`TopdownHeatmapSimpleHead`).

Plain PyTorch and nothing of the program: BN in its eval form, unfolded;
the centred zero padding, the 7x7 windows and their inverse by pad, view
and permute; the relative position index built as mmpose's `WindowMSA`
builds it (`double_step_seq`, flipped); an explicit softmax with the bias;
exact erf GELU; the bilinear upsample (align_corners False) written out
from its source coordinates. TF32 is off while it runs, so a float32
product is a float32 product on a card too.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def published_index(window):
    """mmpose `WindowMSA`'s relative_position_index, as it builds it."""
    def double_step_seq(step1, len1, step2, len2):
        seq1 = torch.arange(0, step1 * len1, step1)
        seq2 = torch.arange(0, step2 * len2, step2)
        return (seq1[:, None] + seq2[None, :]).reshape(1, -1)

    coords = double_step_seq(2 * window - 1, window, 1, window)
    return (coords + coords.T).flip(1).contiguous()


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


class _Net:
    def __init__(self, sd, num_heads, window, ln_eps, bn_eps, fp8=None):
        self.sd, self.heads, self.window = sd, num_heads, window
        self.ln_eps, self.bn_eps, self.fp8 = ln_eps, bn_eps, fp8

    def conv(self, x, name, stride=1, groups=1):
        w = self.sd[name + ".weight"]
        return F.conv2d(x, w, self.sd.get(name + ".bias"), stride, w.shape[-1] // 2,
                        groups=groups)

    def bn(self, x, name):
        sd = self.sd
        scale = sd[name + ".weight"] / torch.sqrt(sd[name + ".running_var"] + self.bn_eps)
        return (x - sd[name + ".running_mean"][:, None, None]) * scale[:, None, None] \
            + sd[name + ".bias"][:, None, None]

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.sd[name + ".weight"], self.sd[name + ".bias"],
                            self.ln_eps)

    def lin(self, x, name):
        w = self.sd[name + ".weight"]
        if self.fp8 is not None:
            x, w = self.fp8(x), self.fp8(w)
        return x @ w.t() + self.sd[name + ".bias"]

    def window_msa(self, u, p, heads):
        """(B, T, C) windows: softmax(q kᵀ d^-0.5 + B) v, then proj."""
        b, t, c = u.shape
        d = c // heads
        q, k, v = self.lin(u, p + ".qkv").reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        table = self.sd[p + ".relative_position_bias_table"]
        bias = table[published_index(self.window).view(-1)].view(t, t, heads).permute(2, 0, 1)
        s = (q * d ** -0.5) @ k.transpose(-2, -1) + bias
        s = torch.exp(s - s.amax(-1, keepdim=True))
        o = ((s / s.sum(-1, keepdim=True)) @ v).transpose(1, 2).reshape(b, t, c)
        return self.lin(o, p + ".proj")

    def local_attn(self, u, h, w, p, heads):
        """(N, H W, C) -> (N, H W, C): centred zero padding, windows,
        attention, windows back, crop."""
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
        u = gelu(self.bn(self.conv(u, f + ".fc1"), f + ".norm1"))
        u = gelu(self.bn(self.conv(u, f + ".dw3x3", groups=u.shape[1]), f + ".norm2"))
        u = gelu(self.bn(self.conv(u, f + ".fc2"), f + ".norm3"))
        return (t.transpose(1, 2).reshape(n, c, h, w) + u)

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


def hrformer_forward(sd, x, num_heads, window=7, ln_eps=1e-6, bn_eps=1e-5):
    """(N, 3, H, W) normalized crops -> (N, J, H/4, W/4) heatmaps, all in
    float32; `sd` the unfolded state_dict (tensors on x's device), the
    published keys; `num_heads` a branch's heads."""
    sd = {k: v.float() for k, v in sd.items() if v.is_floating_point()}
    with no_tf32():
        return _Net(sd, num_heads, window, ln_eps, bn_eps).forward(x.float())
