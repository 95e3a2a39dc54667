"""HRFormer: HRNet's four parallel branches with local-window transformer
blocks in place of its basic blocks, top-down 2D pose, as an nn.Module.

Counterpart of nothing in the JAX package. The published network (Yuan et
al., "HRFormer: High-Resolution Transformer for Dense Prediction", NeurIPS
2021, arXiv:2110.09408; code github.com/HRNet/HRFormer and mmpose's
`mmpose/models/backbones/hrformer.py`, config
`hrformer_base_coco_384x288.py`). Module names follow mmpose's state-dict
keys (`backbone.*`, `keypoint_head.final_layer`).

    stem, stage 1     HRNet's (`models/hrnet.py`): two 3x3 stride-2 convs 64
                      wide with BN and ReLU, 2 Bottlenecks (64 -> 256), the
                      transitions (3x3 conv, BN, ReLU; stride 2 to a new branch)
    stages 2, 3, 4    1, 4 and 2 modules over 2, 3 and 4 branches of widths
                      (78, 156, 312, 624), heads (2, 4, 8, 16): 2 blocks a
                      branch a module, then the fuse layers
    block (tokens x, (N, H W, C); mmpose `HRFormerBlock.forward`):
        x = x + LocalWindowAttn(LN(x))         LayerNorm eps 1e-6
        x = x + CrossFFN(LN(x))
    LocalWindowAttn (`LocalWindowSelfAttention`, `WindowMSA`):
        pad the (H, W) map with zeros to multiples of the window (7), centred:
        pad // 2 before, pad - pad // 2 after, on each axis; cut it into 7x7
        windows; in each, softmax(q kᵀ d^-0.5 + B) v over 49 tokens, d = C /
        heads (39 in every branch of HRFormer-B), B[h, i, j] =
        table[(hᵢ - hⱼ + 6) 13 + (wᵢ - wⱼ + 6), h] (Swin's relative position
        bias, a learned (169, heads) table); no pad mask, so a padded token's
        k and v are the qkv bias; proj; un-cut and crop
    CrossFFN (`CrossFFN.layers`): fc1 1x1 (C -> 4C), BN, GELU; dw3x3 depthwise
        3x3 (4C), BN, GELU; fc2 1x1 (4C -> C), BN, GELU; every GELU exact erf
    fuse (`HRFomerModule._make_fuse_layers`, `HRModule.forward`): row i sums,
        in branch order, x_i and for j > i a 1x1 conv + BN of x_j upsampled
        bilinearly by 2^(j-i) (align_corners False), for j < i a chain of i - j
        steps of depthwise 3x3 stride-2 conv + BN + 1x1 conv + BN, with a ReLU
        after every step but the chain's last; then a ReLU
    head (`TopdownHeatmapSimpleHead`, no deconvolutions): a 1x1 conv 78 -> J
        on branch 0, (N, J, H/4, W/4) heatmaps

Departures, all in rounding only:
* the last module of stage 4 computes the fuse row of branch 0 alone, the
  only one the head reads (mmpose computes all four and drops three), so
  the state_dict has no `stage4.1.fuse_layers.{1,2,3}`;
* BN is folded into the conv before it (`layers.fold_batchnorm`: every
  conv of the network but the head's is followed by one);
* q is scaled inside the scores' product, not before it, and on the card
  the attention is PyTorch's fused kernel (`ops.attention`), fed q, k and v
  zero-padded from d = 39 to 40 by zero rows of the served qkv weights
  (and read back through zero columns of the served proj weights; on the
  CPU too), which adds exact zeros to every score and product;
* the bias of a 1x1 conv before a bilinear upsample is added after the
  upsample (in the sum's epilogue pass): bilinear weights sum to 1.

Served channels-last, a branch's (N, C, H, W) activations are the (N H W,
C) token matrix itself, which LayerNorm and the linears read in place. The
pad and partition is one gather of LN's output into window order (its pad
slots then zeroed), and the un-partition and crop one gather back before
the residual add (`_WindowIndex`); the (heads, 49, 49) bias and the
padded qkv / proj weights are made once a dtype and device
(`WindowMSA.served`). Each FFN conv's bias and GELU, and fc2's residual add
after its GELU (`act_first`), are one pass of the conv epilogue
(`ops.epilogue`, whose flat mode takes the 78- and 156-wide branches), as
are the fuse sums and their ReLU, the bilinear upsample being
`F.interpolate`. The program's spans `stage_a.hrformer.attn` (LN, gather,
qkv, attention, proj, gather back and the add) and `stage_a.hrformer.ffn`
mark each block's two halves (`utils.timing`), inside the facade's
`stage_a.hrnet`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.hrnet import Bottleneck, _conv_bn, _transition
from tpupose_torch.models.layers import BatchNorm2d, ConvOut, Conv2d, conv_out, finish, tensor_out
from tpupose_torch.ops.attention import ALIGN, attention, pad_bias
from tpupose_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class HRFormerConfig:
    num_joints: int = 17
    input_size: tuple = (384, 288)  # (H, W); heatmaps are (H/4, W/4)
    stem_channels: int = 64
    layer1_blocks: int = 2
    layer1_planes: int = 64
    branch_channels: tuple = (78, 156, 312, 624)
    num_heads: tuple = (2, 4, 8, 16)
    stage_modules: tuple = (1, 4, 2)  # stages 2, 3, 4
    stage_blocks: int = 2
    window_size: int = 7
    mlp_ratio: int = 4
    ln_eps: float = 1e-6
    #: Sub-pixel decode refinement, as `HRNetConfig.decode_refine`.
    decode_refine: str = "quarter"

    @property
    def heatmap_size(self):
        return (self.input_size[0] // 4, self.input_size[1] // 4)

    @property
    def branch_sizes(self):
        """(H, W) of each branch: stride-2 3x3 convs halve a size, rounding up."""
        h, w = self.heatmap_size
        out = [(h, w)]
        for _ in self.branch_channels[1:]:
            h, w = -(-h // 2), -(-w // 2)
            out.append((h, w))
        return out


def hrformer_b_config():
    """HRFormer-B at 384x288, the published widths, heads, windows and modules."""
    return HRFormerConfig()


def tiny_hrformer_config():
    """Small config for CPU tests: the same topology at a small crop, narrow
    branches whose head dims (3 and 6) are no multiple of 8, and a 3x3
    window, so that every branch pads and holds several windows."""
    return HRFormerConfig(input_size=(64, 32), stem_channels=16, layer1_blocks=1,
                          layer1_planes=8, branch_channels=(6, 12, 18, 24),
                          num_heads=(2, 2, 3, 4), stage_modules=(1, 1, 1), stage_blocks=1,
                          window_size=3)


def relative_position_index(window):
    """(window^2, window^2) int64: row i, column j holds (hᵢ - hⱼ + w - 1)
    (2w - 1) + (wᵢ - wⱼ + w - 1), the row of the bias table that scores
    token j for query i (Swin's, as HRFormer's `WindowMSA` builds it)."""
    r = torch.arange(window).repeat_interleave(window)
    c = torch.arange(window).repeat(window)
    return (r[:, None] - r[None, :] + window - 1) * (2 * window - 1) \
        + (c[:, None] - c[None, :] + window - 1)


class _WindowIndex(NamedTuple):
    """A map's window order: `src` (S,) the token (row-major over the
    (H, W) map) at each of the S slots of the padded map cut into windows
    (windows row-major, tokens row-major in a window; a pad slot holds 0),
    `pad` the pad slots, `dst` (H W,) the slot of each token."""

    src: torch.Tensor
    pad: torch.Tensor
    dst: torch.Tensor


@functools.lru_cache(maxsize=None)
def window_index(h, w, window, device):
    """The `_WindowIndex` of an (h, w) map, made once a device."""
    hp, wp = h + -h % window, w + -w % window
    top, left = (hp - h) // 2, (wp - w) // 2
    nh, nw = hp // window, wp // window
    rows = torch.arange(hp).view(nh, 1, window, 1).expand(nh, nw, window, window)
    cols = torch.arange(wp).view(1, nw, 1, window).expand(nh, nw, window, window)
    rows, cols = rows.reshape(-1) - top, cols.reshape(-1) - left
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    src = torch.where(inside, rows * w + cols, 0)
    dst = torch.empty(h * w, dtype=torch.int64)
    dst[src[inside]] = inside.nonzero().view(-1)
    return _WindowIndex(src.to(device), (~inside).nonzero().view(-1).to(device), dst.to(device))


def partition(t, h, w, window):
    """(N, H W, C) tokens -> (N, S, C) in window order, the pad slots zero:
    one gather (and a fill of the pad slots)."""
    idx = window_index(h, w, window, t.device)
    out = t.index_select(1, idx.src)
    if idx.pad.numel():
        out.index_fill_(1, idx.pad, 0)
    return out


def unpartition(y, h, w, window):
    """(N, S, C) in window order -> (N, H W, C), the pad slots dropped: one
    gather."""
    return y.index_select(1, window_index(h, w, window, y.device).dst)


class _Served(NamedTuple):
    key: tuple
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    bias: torch.Tensor


class WindowMSA(nn.Module):
    """Multi-head self-attention in one window with a relative position
    bias (mmpose `WindowMSA`, keys `relative_position_bias_table`,
    `relative_position_index`, `qkv`, `proj`); its forward takes windows
    (B, T, C)."""

    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._served = None

    def _apply(self, fn, *args, **kwargs):
        self._served = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._served = None
        super()._load_from_state_dict(*args, **kwargs)

    def served(self, dtype, device):
        """(qkv weight, qkv bias, proj weight, proj bias, bias) in `dtype`:
        each head's q, k and v rows zero-padded to the next multiple of 8
        (what the fused attention takes; 39 -> 40), the proj's columns
        likewise, and the (heads, T, T) bias gathered from the table
        (`attention.pad_bias`'s layout); made once and kept until a
        parameter changes."""
        h, d = self.num_heads, self.head_dim
        dp = -(-d // ALIGN) * ALIGN
        params = (self.relative_position_bias_table, self.qkv.weight, self.qkv.bias,
                  self.proj.weight, self.proj.bias)
        key = (dtype, str(device), *((p.data_ptr(), p._version) for p in params))
        if self._served is not None and self._served.key == key:
            return self._served
        c = h * d
        with torch.no_grad():
            t = self.window ** 2
            bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
            bias = pad_bias(bias.view(t, t, h).permute(2, 0, 1).to(dtype))
            wq = F.pad(self.qkv.weight.view(3, h, d, c), (0, 0, 0, dp - d))
            bq = F.pad(self.qkv.bias.view(3, h, d), (0, dp - d))
            wp = F.pad(self.proj.weight.view(c, h, d), (0, dp - d))
            self._served = _Served(key, wq.reshape(3 * h * dp, c).to(dtype),
                                   bq.reshape(-1).to(dtype), wp.reshape(c, h * dp).to(dtype),
                                   self.proj.bias.to(dtype), bias)
        return self._served

    def forward(self, x):
        """(B, T, C) windows -> (B, T, C)."""
        s = self.served(x.dtype, x.device)
        b, t, _ = x.shape
        dp = s.qkv_w.shape[0] // (3 * self.num_heads)
        qkv = F.linear(x, s.qkv_w, s.qkv_b).view(b, t, 3, self.num_heads, dp)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, self.scale, s.bias)
        return F.linear(o.transpose(1, 2).reshape(b, t, -1), s.proj_w, s.proj_b)


class LocalWindowSelfAttention(nn.Module):
    """mmpose's wrapper (keys `attn.*`): the padded, windowed `WindowMSA`."""

    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.window = window
        self.attn = WindowMSA(dim, num_heads, window)

    def forward(self, x, h, w):
        """(N, H W, C) LN'd tokens -> (N, H W, C): one gather into window
        order, the windows' attention, one gather back."""
        n, _, c = x.shape
        xp = partition(x, h, w, self.window)
        y = self.attn(xp.view(-1, self.window ** 2, c)).view(n, -1, c)
        return unpartition(y, h, w, self.window)


class CrossFFN(nn.Module):
    """fc1 1x1, BN, GELU, dw3x3 depthwise, BN, GELU, fc2 1x1, BN, GELU
    (mmpose keys; each conv's BN is the `normK` named in `bn_pairs`)."""

    bn_pairs = {"fc1": "norm1", "dw3x3": "norm2", "fc2": "norm3"}

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1, bias=True)
        self.norm1 = BatchNorm2d(hidden)
        self.dw3x3 = Conv2d(hidden, hidden, 3, bias=True, groups=hidden)
        self.norm2 = BatchNorm2d(hidden)
        self.fc2 = Conv2d(hidden, dim, 1, bias=True)
        self.norm3 = BatchNorm2d(dim)

    def forward(self, x, skip):
        """skip + GELU(BN(fc2(...))) of channels-last x: three epilogue passes."""
        x = finish(conv_out(self.fc1, self.norm1, x, any_width=True), act="gelu")
        x = finish(conv_out(self.dw3x3, self.norm2, x, any_width=True), act="gelu")
        return finish(conv_out(self.fc2, self.norm3, x, any_width=True), skip=skip,
                      act="gelu", act_first=True)


def _layer_norm(m, x):
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype), m.bias.to(x.dtype), m.eps)


class HRFormerBlock(nn.Module):
    """x + attn(LN(x)), then x + ffn(LN(x)) on a channels-last (N, C, H, W)
    map read as its (N, H W, C) tokens."""

    def __init__(self, dim, num_heads, window, mlp_ratio, ln_eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = LocalWindowSelfAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.ffn = CrossFFN(dim, dim * mlp_ratio)

    def forward(self, x):
        n, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1).reshape(n, h * w, c)  # a view where x is channels-last
        with timing.span("stage_a.hrformer.attn", t):
            t = t + self.attn(_layer_norm(self.norm1, t), h, w)
        with timing.span("stage_a.hrformer.ffn", t):
            u = _layer_norm(self.norm2, t).view(n, h, w, c).permute(0, 3, 1, 2)
            x = self.ffn(u, t.view(n, h, w, c).permute(0, 3, 1, 2))
        return x


def _conv_bn_relu(seq, x):
    """A transition's Sequential(conv, bn) on x, then ReLU: one epilogue
    pass at any width."""
    return finish(conv_out(seq[0], seq[1], x, any_width=True), act="relu")


def _down_step(cin, cout):
    """One stride-2 step of a fuse chain: depthwise 3x3 stride-2 conv, BN,
    1x1 conv, BN (keys 0 to 3; the ReLU between steps has no parameters)."""
    return nn.Sequential(Conv2d(cin, cin, 3, stride=2, groups=cin), BatchNorm2d(cin),
                         Conv2d(cin, cout, 1), BatchNorm2d(cout))


class HRFormerModule(nn.Module):
    """One multi-branch module: HRFormer blocks on every branch, then the
    fuse rows of the first `out_branches` branches."""

    def __init__(self, cfg: HRFormerConfig, n_branches, out_branches):
        super().__init__()
        ch = cfg.branch_channels[:n_branches]
        self.branches = nn.ModuleList(
            nn.Sequential(*(HRFormerBlock(c, cfg.num_heads[b], cfg.window_size, cfg.mlp_ratio,
                                          cfg.ln_eps) for _ in range(cfg.stage_blocks)))
            for b, c in enumerate(ch))
        fuse = []
        for i in range(out_branches):
            row = []
            for j in range(n_branches):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(_conv_bn(ch[j], ch[i], 1))
                else:
                    row.append(nn.Sequential(*(_down_step(ch[j], ch[i] if k == i - j - 1 else ch[j])
                                               for k in range(i - j))))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        ys = []
        for branch, x in zip(self.branches, xs):
            for block in branch:
                x = block(x)
            ys.append(x)
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, yj in enumerate(ys):
                if j == i:
                    term = tensor_out(yj, any_width=True)
                elif j > i:
                    out = conv_out(row[j][0], row[j][1], yj, any_width=True)
                    up = F.interpolate(out.y, scale_factor=2 ** (j - i), mode="bilinear",
                                       align_corners=False)
                    term = ConvOut(up, out.bias, out.fused)
                else:
                    x = yj
                    for k, step in enumerate(row[j]):
                        x = finish(conv_out(step[0], step[1], x, any_width=True))
                        term = conv_out(step[2], step[3], x, any_width=True)
                        if k < len(row[j]) - 1:
                            x = finish(term, act="relu")
                acc = finish(term, skip=acc, act="relu" if j == len(ys) - 1 else None)
            outs.append(acc)
        return outs


class HRFormerBackbone(nn.Module):
    """(N, 3, H, W) -> branch 0's (N, C0, H/4, W/4), in the input's layout
    (keys `conv1` ... `stage4`, as mmpose's HRNet / HRFormer)."""

    def __init__(self, cfg: HRFormerConfig):
        super().__init__()
        w = cfg.branch_channels
        self.conv1 = Conv2d(3, cfg.stem_channels, 3, stride=2)
        self.bn1 = BatchNorm2d(cfg.stem_channels)
        self.conv2 = Conv2d(cfg.stem_channels, cfg.stem_channels, 3, stride=2)
        self.bn2 = BatchNorm2d(cfg.stem_channels)
        blocks, cin = [], cfg.stem_channels
        for _ in range(cfg.layer1_blocks):
            blocks.append(Bottleneck(cin, cfg.layer1_planes))
            cin = cfg.layer1_planes * Bottleneck.expansion
        self.layer1 = nn.Sequential(*blocks)
        self.transition1 = nn.ModuleList([_conv_bn(cin, w[0], 3), _transition(cin, w[1])])
        self.transition2 = nn.ModuleList([None, None, _transition(w[1], w[2])])
        self.transition3 = nn.ModuleList([None, None, None, _transition(w[2], w[3])])
        for s, n_mod in enumerate(cfg.stage_modules):
            n_br, last = s + 2, s == len(cfg.stage_modules) - 1
            setattr(self, f"stage{s + 2}", nn.Sequential(*(
                HRFormerModule(cfg, n_br, 1 if last and m == n_mod - 1 else n_br)
                for m in range(n_mod))))

    def forward(self, x):
        x = finish(conv_out(self.conv1, self.bn1, x), act="relu")
        x = finish(conv_out(self.conv2, self.bn2, x), act="relu")
        for block in self.layer1:
            x = block(x)
        xs = [_conv_bn_relu(self.transition1[0], x), _conv_bn_relu(self.transition1[1][0], x)]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [_conv_bn_relu(self.transition2[2][0], xs[-1])])
        xs = self.stage4(xs + [_conv_bn_relu(self.transition3[3][0], xs[-1])])
        return xs[0]


class SimpleHead(nn.Module):
    """`TopdownHeatmapSimpleHead` without deconvolutions: `final_layer`."""

    def __init__(self, cin, num_joints):
        super().__init__()
        self.final_layer = Conv2d(cin, num_joints, 1, bias=True)


class HRFormer(nn.Module):
    """HRFormer: (N, 3, H, W) -> (N, J, H/4, W/4) f32 heatmaps, in the
    input's layout."""

    def __init__(self, cfg: HRFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = HRFormerBackbone(cfg)
        self.keypoint_head = SimpleHead(cfg.branch_channels[0], cfg.num_joints)

    def forward(self, x, compute_dtype=torch.bfloat16):
        x = self.backbone(x.to(compute_dtype))
        return self.keypoint_head.final_layer(x).to(torch.float32)


@torch.no_grad()
def hrformer_init(cfg: HRFormerConfig, generator: torch.Generator) -> HRFormer:
    """An HRFormer with random weights drawn from `generator`: convs
    He-normal (fan-in Cin / groups k^2) with zero biases, identity BN
    statistics; linears and the bias tables truncated-normal (std 0.02, cut
    at 2 std) with zero biases, LayerNorms 1 and 0 (the published
    transformer initialization)."""
    model = HRFormer(cfg)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _trunc_normal(m.weight, 0.02, generator)
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, WindowMSA):
            _trunc_normal(m.relative_position_bias_table, 0.02, generator)
    return model


def _trunc_normal(t, std, generator):
    """t filled from N(0, std) cut at +-2 std, by redrawing what falls out."""
    t.normal_(0.0, std, generator=generator)
    out = t.abs() > 2 * std
    while out.any():
        t[out] = torch.empty(int(out.sum()), dtype=t.dtype).normal_(0.0, std,
                                                                    generator=generator)
        out = t.abs() > 2 * std
