"""ViTPose: a plain vision transformer and a deconvolution head, top-down
2D pose, as an nn.Module.

Counterpart of nothing in the JAX package. The published network
(Xu et al., "ViTPose", NeurIPS 2022, arXiv:2204.12484; the official
`mmpose/models/backbones/vit.py` and `TopdownHeatmapSimpleHead`, config
`ViTPose_huge_coco_256x192.py`). Module names equal the official
checkpoint's keys (`backbone.*`, `keypoint_head.*`), so a real `.pth`
loads with no renaming (`models.convert.load_vitpose_checkpoint`).

    tokens  = patch_embed.proj(x) flattened, Conv2d(3, C, 16, stride 16, padding 2):
              256x192 -> 16x12 = 192 tokens of C
    tokens += pos_embed[:, 1:] + pos_embed[:, :1]     (no class token)
    each block: t = t + proj(attn(qkv(norm1(t))))      16 heads, softmax(q kᵀ d^-0.5) v
                t = t + fc2(gelu(fc1(norm2(t))))        exact erf GELU, LayerNorm eps 1e-6
    last_norm, tokens -> (N, C, 16, 12)
    head: [ConvTranspose2d(C, 256, 4, 2, 1), BN, ReLU] x 2 (256 -> 256), final_layer 1x1
          -> (N, J, 64, 48)

Departures, all in rounding only: the two position terms are summed first
(in float32, then cast), so the tokens take one add; the attention is
PyTorch's fused kernel on the card (`ops.attention`).

The forward takes an (N, 3, H, W) normalized image, a channels-last view
of the NHWC crops on the served path, and returns f32 (N, J, H/4, W/4)
heatmaps. The patch embedding's channels-last output is the token matrix
itself, (N * T, C) row-major, which the linears read in place; the head
reads the tokens back as a channels-last (N, C, h, w) view. After
`layers.fold_batchnorm` each deconvolution carries its BN as a bias, and on
a served channels-last input its bias and ReLU are one pass of the conv
epilogue (`layers.finish`), as a `Conv2d`'s are. The program's spans
`stage_a.vitpose.blocks` (patch embedding, blocks, `last_norm`) and
`stage_a.vitpose.head` mark the two parts (`utils.timing`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.layers import BatchNorm2d, deconv_out, finish
from tpupose_torch.ops.attention import attention
from tpupose_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class ViTPoseConfig:
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 16
    patch_padding: int = 2
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    input_size: tuple = (256, 192)  # (H, W); heatmaps are (H/4, W/4)
    num_joints: int = 17
    deconv_filters: tuple = (256, 256)
    deconv_kernel: int = 4
    bn_eps: float = 1e-5
    #: Sub-pixel decode refinement, as `HRNetConfig.decode_refine`.
    decode_refine: str = "quarter"

    @property
    def patch_grid(self):
        """(h, w) of the token grid: the patch conv's output size."""
        p, pad = self.patch_size, self.patch_padding
        return tuple((s + 2 * pad - p) // p + 1 for s in self.input_size)

    @property
    def num_patches(self):
        """Tokens a crop: the published count, (H / p) * (W / p)."""
        return (self.input_size[0] // self.patch_size) * (self.input_size[1] // self.patch_size)

    @property
    def heatmap_size(self):
        return (self.input_size[0] // 4, self.input_size[1] // 4)


def vitpose_h_config():
    """ViTPose-H at 256x192, the published widths and depth."""
    return ViTPoseConfig()


def tiny_vitpose_config():
    """Small config for CPU tests: the same topology, a narrow and shallow
    backbone at a small crop (the head keeps its published widths)."""
    return ViTPoseConfig(embed_dim=32, depth=2, num_heads=4, input_size=(64, 48))


def _linear(m, x):
    """m's linear map in x's dtype."""
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def _layer_norm(m, x):
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype), m.bias.to(x.dtype), m.eps)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size,
                              padding=cfg.patch_padding)

    def forward(self, x):
        """(N, 3, H, W) -> (N, T, C) tokens, row-major over the grid."""
        w = self.proj.weight.to(x.dtype)
        y = F.conv2d(x, w, self.proj.bias.to(x.dtype), self.proj.stride, self.proj.padding)
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, t, c = x.shape
        qkv = _linear(self.qkv, x).view(n, t, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, self.scale)
        return _linear(self.proj, o.transpose(1, 2).reshape(n, t, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        c = cfg.embed_dim
        self.norm1 = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.attn = Attention(c, cfg.num_heads, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.mlp = Mlp(c, c * cfg.mlp_ratio)

    def forward(self, x):
        x = x + self.attn(_layer_norm(self.norm1, x))
        return x + self.mlp(_layer_norm(self.norm2, x))


class ViT(nn.Module):
    """The backbone: (N, 3, H, W) -> (N, C, h, w), a channels-last view of
    the (N * T, C) tokens."""

    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.grid = cfg.patch_grid
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, x):
        t = self.patch_embed(x)
        pos = self.pos_embed.float()
        t = t + (pos[:, 1:] + pos[:, :1]).to(t.dtype)
        for block in self.blocks:
            t = block(t)
        t = _layer_norm(self.last_norm, t)
        h, w = self.grid
        return t.view(t.shape[0], h, w, t.shape[2]).permute(0, 3, 1, 2)


class TopdownHeatmapSimpleHead(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        layers, cin = [], cfg.embed_dim
        k = cfg.deconv_kernel
        for planes in cfg.deconv_filters:
            # k 4 (published) or 2: padding 1 or 0, no output padding
            layers += [nn.ConvTranspose2d(cin, planes, k, stride=2, padding=(k - 2) // 2,
                                          bias=False),
                       BatchNorm2d(planes, eps=cfg.bn_eps), nn.ReLU()]
            cin = planes
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, cfg.num_joints, 1)

    def forward(self, x):
        seq = self.deconv_layers
        for i in range(0, len(seq), 3):  # (deconv, bn, relu) triples
            x = finish(deconv_out(seq[i], seq[i + 1], x), act="relu")
        w = self.final_layer.weight.to(x.dtype)
        return F.conv2d(x, w, self.final_layer.bias.to(x.dtype))


class ViTPose(nn.Module):
    """ViTPose: (N, 3, H, W) -> (N, J, H/4, W/4) f32 heatmaps."""

    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg)
        self.keypoint_head = TopdownHeatmapSimpleHead(cfg)

    def forward(self, x, compute_dtype=torch.bfloat16):
        x = x.to(compute_dtype)
        with timing.span("stage_a.vitpose.blocks", x):
            feats = self.backbone(x)
        with timing.span("stage_a.vitpose.head", x):
            heat = self.keypoint_head(feats)
        return heat.to(torch.float32)


@torch.no_grad()
def vitpose_init(cfg: ViTPoseConfig, generator: torch.Generator) -> ViTPose:
    """A ViTPose with random weights drawn from `generator`: the linears'
    weights and `pos_embed` truncated-normal (std 0.02, cut at 2 std) with
    zero biases, LayerNorms 1 and 0 (the published initialization); the
    patch embedding, deconvolutions and final layer He-normal (a
    deconvolution's fan-in is the inputs that reach one output, Cin * k^2 /
    stride^2), zero conv biases and identity BN statistics, as HRNet's."""
    model = ViTPose(cfg)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _trunc_normal(m.weight, 0.02, generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            k = m.kernel_size[0] * m.kernel_size[1]
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels * k / (m.stride[0] * m.stride[1])
            else:
                fan_in = m.in_channels * k
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    _trunc_normal(model.backbone.pos_embed, 0.02, generator)
    return model


def _trunc_normal(t, std, generator):
    """t filled from N(0, std) cut at +-2 std, by redrawing what falls out."""
    t.normal_(0.0, std, generator=generator)
    out = t.abs() > 2 * std
    while out.any():
        t[out] = torch.empty(int(out.sum()), dtype=t.dtype).normal_(0.0, std,
                                                                    generator=generator)
        out = t.abs() > 2 * std
