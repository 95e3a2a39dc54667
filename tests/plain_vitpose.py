"""The plain ViTPose forward: the published equations written out in
float32 over a state_dict with the official keys (`backbone.*`,
`keypoint_head.*`; Xu et al., arXiv:2204.12484, the official
`mmpose/models/backbones/vit.py` and `TopdownHeatmapSimpleHead`).

Plain PyTorch and nothing of the program: an explicit softmax, the
transposed convolutions by `F.conv_transpose2d`, BN in its eval form, no
kernel, no folding, no batching trick. TF32 is off while it runs, so a
float32 product is a float32 product on a card too.
"""
from __future__ import annotations

import contextlib

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


def _ln(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"], sd[name + ".bias"], eps)


def _lin(x, sd, name):
    return x @ sd[name + ".weight"].t() + sd[name + ".bias"]


def vitpose_forward(sd, x, num_heads, patch_size=16, patch_padding=2, ln_eps=1e-6,
                    bn_eps=1e-5):
    """(N, 3, H, W) normalized crops -> (N, J, H/4, W/4) heatmaps, all in
    float32; `sd` the unfolded state_dict (float32 tensors on x's device)."""
    sd = {k: v.float() for k, v in sd.items()}
    with no_tf32():
        x = F.conv2d(x.float(), sd["backbone.patch_embed.proj.weight"],
                     sd["backbone.patch_embed.proj.bias"], stride=patch_size,
                     padding=patch_padding)
        n, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)                       # (N, T, C)
        pos = sd["backbone.pos_embed"]
        x = x + pos[:, 1:] + pos[:, :1]
        d = c // num_heads
        depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("backbone.blocks."))
        for i in range(depth):
            b = f"backbone.blocks.{i}"
            h = _ln(x, sd, b + ".norm1", ln_eps)
            qkv = _lin(h, sd, b + ".attn.qkv").reshape(n, -1, 3, num_heads, d)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            scores = (q * d ** -0.5) @ k.transpose(-2, -1)
            scores = torch.exp(scores - scores.amax(-1, keepdim=True))
            attn = scores / scores.sum(-1, keepdim=True)
            o = (attn @ v).transpose(1, 2).reshape(n, -1, c)
            x = x + _lin(o, sd, b + ".attn.proj")
            h = _ln(x, sd, b + ".norm2", ln_eps)
            h = _lin(h, sd, b + ".mlp.fc1")
            h = 0.5 * h * (1.0 + torch.erf(h / 2 ** 0.5))
            x = x + _lin(h, sd, b + ".mlp.fc2")
        x = _ln(x, sd, "backbone.last_norm", ln_eps)
        x = x.transpose(1, 2).reshape(n, c, hp, wp)
        i = 0
        while f"keypoint_head.deconv_layers.{i}.weight" in sd:
            p, q = f"keypoint_head.deconv_layers.{i}", f"keypoint_head.deconv_layers.{i + 1}"
            x = F.conv_transpose2d(x, sd[p + ".weight"], None, stride=2, padding=1)
            scale = sd[q + ".weight"] / torch.sqrt(sd[q + ".running_var"] + bn_eps)
            x = (x - sd[q + ".running_mean"][:, None, None]) * scale[:, None, None] \
                + sd[q + ".bias"][:, None, None]
            x = torch.relu(x)
            i += 3
        return F.conv2d(x, sd["keypoint_head.final_layer.weight"],
                        sd["keypoint_head.final_layer.bias"])
