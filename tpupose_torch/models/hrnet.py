"""HRNet top-down 2D pose network as an nn.Module (in its input's layout).

Counterpart of `tpupose/models/hrnet.py`. Module names equal the official
`pose_hrnet` state_dict keys (conv1/bn1/.../layer1.N.convK/transitionK/
stageK.M.branches.B.L/fuse_layers.I.J/final_layer), so an official `.pth`
loads with no renaming. The forward takes an (N, 3, H, W) normalized image
and returns (N, J, H/4, W/4) f32 heatmaps in the input's layout: the
served path gives it a channels-last view of its NHWC crops (the JAX
package's NHWC) and makes the heatmaps NCHW-contiguous once, the layout
the decode kernel reads.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tpupose_torch.models import quantize
from tpupose_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    chain_out,
    conv_out,
    finish,
    he_normal_init_,
    residual,
    tensor_out,
)
from tpupose_torch.ops.packing import pack_width, unpack_width


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    width: int = 48
    num_joints: int = 17
    input_size: tuple = (384, 288)  # (H, W); heatmaps are (H/4, W/4)
    stem_channels: int = 64
    layer1_blocks: int = 4
    layer1_planes: int = 64
    stage_modules: tuple = (1, 4, 3)  # stages 2, 3, 4
    stage_blocks: int = 4
    #: Width-packed branch 0 (`tpupose_torch.ops.packing`): each stage
    #: module packs branch 0's (N, C, H, W) activations to (N, 2C, H, W/2)
    #: before its basic blocks and unpacks them after, and those blocks'
    #: convs are 2C -> 2C (the shape of a packed tree). Make a packed model
    #: with `packing.pack_hrnet_branch0` from a folded one
    #: (`Pipeline.pack_models`); `HRNet` of such a config builds the
    #: skeleton a packed state_dict loads into.
    pack_branch0: bool = False
    #: Fused int8-resident blocks: in a quantized model, each basic block and
    #: bottleneck whose convs are all quantized (BN folded) requantizes in
    #: the conv epilogue, so the inter-conv tensors move as int8
    #: (`quantize.quantized_basic_block` / `quantized_bottleneck`).
    int8_resident: bool = False
    #: Sub-pixel decode refinement: "quarter" (official HRNet, default) or
    #: "parabolic".
    decode_refine: str = "quarter"

    @property
    def branch_channels(self):
        w = self.width
        return (w, 2 * w, 4 * w, 8 * w)

    @property
    def heatmap_size(self):
        return (self.input_size[0] // 4, self.input_size[1] // 4)


def hrnet_w48_config():
    return HRNetConfig(width=48)


def hrnet_w32_config(input_size=(256, 192)):
    """The official pose_hrnet_w32 (same key set at 256x192 and 384x288)."""
    return HRNetConfig(width=32, input_size=tuple(input_size))


def tiny_test_config():
    """Small config for CPU tests: same topology, few channels and blocks."""
    return HRNetConfig(
        width=8,
        input_size=(96, 64),
        stem_channels=16,
        layer1_blocks=1,
        layer1_planes=8,
        stage_modules=(1, 1, 1),
        stage_blocks=1,
    )


def _conv_bn(cin, cout, k, stride=1):
    return nn.Sequential(Conv2d(cin, cout, k, stride=stride), BatchNorm2d(cout))


def _conv_bn_relu(seq, x):
    """A transition's Sequential(conv, bn) on x, then ReLU, its epilogue one
    pass where served (`layers.conv_out`)."""
    return finish(conv_out(seq[0], seq[1], x), act="relu")


def _fusable(block, convs, bns):
    """Every conv quantized and no live BN between them (folded BNs are
    nn.Identity): the condition for an int8-resident block."""
    return (all(quantize.is_quantized_conv(getattr(block, c)) for c in convs)
            and all(isinstance(getattr(block, b), nn.Identity) for b in bns))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = _conv_bn(cin, cout, 1) if cin != cout else None

    def forward(self, x, resident=False):
        if resident and _fusable(self, ("conv1", "conv2"), ("bn1", "bn2")):
            return quantize.quantized_basic_block(self, x)
        y = chain_out(x, (self.conv1, self.bn1), (self.conv2, self.bn2), act="relu")
        return finish(y, skip=residual(self, x), act="relu")


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = _conv_bn(cin, cout, 1) if cin != cout else None

    def forward(self, x, resident=False):
        if resident and _fusable(self, ("conv1", "conv2", "conv3"), ("bn1", "bn2", "bn3")):
            return quantize.quantized_bottleneck(self, x)
        y = chain_out(x, (self.conv1, self.bn1), (self.conv2, self.bn2),
                      (self.conv3, self.bn3), act="relu")
        return finish(y, skip=residual(self, x), act="relu")


class HighResolutionModule(nn.Module):
    """One multi-branch module: BasicBlock branches then the fuse layers
    (fuse_layers[i][j]: None for j == i, 1x1 conv + BN + upsample for
    j > i, a chain of stride-2 3x3 convs for j < i). With `pack0`, branch
    0's blocks are built for width-packed activations (twice the
    channels)."""

    def __init__(self, channels, num_blocks, out_branches, pack0=False):
        super().__init__()
        widths = [2 * c if pack0 and b == 0 else c for b, c in enumerate(channels)]
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c) for _ in range(num_blocks)))
            for c in widths
        )
        fuse = []
        for i in range(out_branches):
            row = []
            for j in range(len(channels)):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1))
                else:
                    n = i - j
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[j], channels[i] if k == n - 1 else channels[j],
                                 3, stride=2)
                        for k in range(n)
                    )))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs, resident=False, pack0=False):
        ys = []
        for b, (branch, x) in enumerate(zip(self.branches, xs)):
            if pack0 and b == 0:
                x = pack_width(x)  # branch-0 blocks carry width-packed kernels
            for block in branch:
                x = block(x, resident)
            if pack0 and b == 0:
                x = unpack_width(x)
            ys.append(x)
        # each row sums its terms in branch order into `acc`, the skip of
        # the next term's epilogue: a coarser branch's 1x1 conv is read
        # through a nearest upsample, a finer one's stride-2 chain ends in
        # its last conv, and the last term's epilogue applies the ReLU
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, yj in enumerate(ys):
                if j == i:
                    term = tensor_out(yj)
                elif j > i:
                    term = conv_out(row[j][0], row[j][1], yj)
                else:
                    term = chain_out(yj, *((step[0], step[1]) for step in row[j]),
                                     act="relu")
                acc = finish(term, skip=acc, up=max(j - i, 0),
                             act="relu" if j == len(ys) - 1 else None)
            outs.append(acc)
        return outs


def _transition(cin, cout):
    """A stride-2 transition to a new branch: Sequential(Sequential(conv,
    bn)), keys transitionK.B.0.{0,1}; the forward applies its ReLU
    (`_conv_bn_relu`)."""
    return nn.Sequential(_conv_bn(cin, cout, 3, stride=2))


class HRNet(nn.Module):
    """pose_hrnet: (N, 3, H, W) -> (N, J, H/4, W/4) f32 heatmaps, in the
    input's layout."""

    def __init__(self, cfg: HRNetConfig):
        super().__init__()
        self.cfg = cfg
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
        self.transition1 = nn.ModuleList([
            _conv_bn(cin, w[0], 3),
            _transition(cin, w[1]),
        ])
        self.transition2 = nn.ModuleList([None, None, _transition(w[1], w[2])])
        self.transition3 = nn.ModuleList([None, None, None, _transition(w[2], w[3])])
        for s, (n_mod, n_br) in enumerate(zip(cfg.stage_modules, (2, 3, 4))):
            last_stage = s == len(cfg.stage_modules) - 1
            setattr(self, f"stage{s + 2}", nn.Sequential(*(
                HighResolutionModule(
                    w[:n_br], cfg.stage_blocks,
                    1 if (last_stage and m == n_mod - 1) else n_br, cfg.pack_branch0)
                for m in range(n_mod)
            )))
        self.final_layer = Conv2d(w[0], cfg.num_joints, 1, bias=True)

    def forward(self, x, compute_dtype=torch.bfloat16):
        x = x.to(compute_dtype)
        x = finish(conv_out(self.conv1, self.bn1, x), act="relu")
        x = finish(conv_out(self.conv2, self.bn2, x), act="relu")
        resident, pack0 = self.cfg.int8_resident, self.cfg.pack_branch0
        for block in self.layer1:
            x = block(x, resident)
        xs = [_conv_bn_relu(self.transition1[0], x), _conv_bn_relu(self.transition1[1][0], x)]
        for module in self.stage2:
            xs = module(xs, resident, pack0)
        xs = xs + [_conv_bn_relu(self.transition2[2][0], xs[-1])]
        for module in self.stage3:
            xs = module(xs, resident, pack0)
        xs = xs + [_conv_bn_relu(self.transition3[3][0], xs[-1])]
        for module in self.stage4:
            xs = module(xs, resident, pack0)
        return self.final_layer(xs[0]).to(torch.float32)


def hrnet_init(cfg: HRNetConfig, generator: torch.Generator) -> HRNet:
    """An HRNet with He-normal random weights drawn from `generator`."""
    return he_normal_init_(HRNet(cfg), generator)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(x, value_scale=255.0):
    """RGB (..., 3) in [0, value_scale] -> ImageNet-normalized. Floating
    inputs keep their dtype (a bf16 crop stays bf16); integers become f32.
    The result is contiguous whatever x's strides: its first operation
    writes it so, at no extra pass (the crop products leave W-major
    memory, and HRNet reads the crops' channels-last view)."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    dt = x.dtype
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = torch.div(x, torch.tensor(value_scale, dtype=dt, device=x.device),
                  out=torch.empty(x.shape, dtype=dt, device=x.device))
    return (x - mean.to(dt)) * (1.0 / std).to(dt)
