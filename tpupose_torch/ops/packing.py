"""Width packing of HRNet branch 0: pairs of columns become channels.

Counterpart of `tpupose/ops/packing.py`. An activation (N, C, H, W) becomes
(N, 2C, H, W/2): packed channel p*C + c holds original column 2J + p (the
JAX package's phase-major channel order, so a packed JAX tree converts with
`models.convert.hrnet_state_dict_from_jax` unchanged). A 3x3 stride-1 conv
on the original is then a 3x3 stride-1 conv on the packed tensor with twice
the channels and a kernel whose entries are

    W'[q*C + co, p*C + ci, dy, B + 1] = W[co, ci, dy, dx + 1],  dx = 2B + p - q,

nonzero only for dx in {-1, 0, 1}: half the entries are structural zeros,
so the packed conv does twice the multiply-adds. The padding of one packed
column covers the original one-column padding (the extra original column
it implies meets only zero entries), and int8's zero-point 0 keeps zeros
exact, so packed and unpacked convs agree to the order of their sums, and
exactly in int8's int32 sums.

The JAX package packed for the TPU's 128-wide lanes, where C = 48 pads to
128. In NHWC packing is a free reshape; in the port's NCHW it is a
permute-copy each way (`pack_width`, `unpack_width`), paid at every stage
module's branch 0. Whether packing pays on a GPU is a measurement
(`chip_smoke.py` phase 16); nothing packs unless asked.
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


def pack_width(x):
    """(N, C, H, W) -> (N, 2C, H, W/2); channel p*C + c = column 2J + p.
    A copy (NCHW is not the layout in which packing is a reshape)."""
    n, c, h, w = x.shape
    if w % 2:
        raise ValueError(f"width {w} must be even to pack")
    return x.reshape(n, c, h, w // 2, 2).permute(0, 4, 1, 2, 3).reshape(n, 2 * c, h, w // 2)


def unpack_width(y):
    """Inverse of `pack_width`: (N, 2C, H, W/2) -> (N, C, H, W)."""
    n, c2, h, wp = y.shape
    c = c2 // 2
    return y.reshape(n, 2, c, h, wp).permute(0, 2, 3, 4, 1).reshape(n, c, h, 2 * wp)


def pack_conv_weight_width(w):
    """(Cout, Cin, kh, 3) stride-1 kernel -> its (2Cout, 2Cin, kh, 3) packed
    equivalent (50% structural zeros), same dtype and device."""
    cout, cin, kh, kw = w.shape
    if kw != 3:
        raise ValueError(f"width packing expects 3-wide kernels, got {kw}")
    out = torch.zeros((2 * cout, 2 * cin, kh, 3), dtype=w.dtype, device=w.device)
    for q in (0, 1):          # output phase
        for p in (0, 1):      # input phase
            for b in (-1, 0, 1):  # packed column offset
                dx = 2 * b + p - q
                if -1 <= dx <= 1:
                    out[q * cout:(q + 1) * cout, p * cin:(p + 1) * cin, :, b + 1] = w[..., dx + 1]
    return out


def pack_conv_module_width(conv):
    """The packed counterpart of one stride-1 3-wide conv: a folded
    `layers.Conv2d` (packed weight, bias tiled over the two phases) or a
    `layers.QuantConv2d` (packed `weight_q`, `w_scale` and `bias` tiled,
    the per-tensor `x_scale` kept: a permutation does not change a
    tensor's range). Counterpart of `pack_conv_dict_width`."""
    from tpupose_torch.models.layers import Conv2d, QuantConv2d

    def tile(t):
        return None if t is None else t.detach().repeat(2)

    if isinstance(conv, QuantConv2d):
        if (conv.stride, conv.dilation) != (1, 1):
            raise ValueError("width packing needs a stride-1, undilated conv")
        return QuantConv2d(pack_conv_weight_width(conv.weight_q), tile(conv.w_scale),
                           conv.x_scale.clone(), tile(conv.bias))
    if type(conv) is not Conv2d or conv.stride != (1, 1) or conv.dilation != (1, 1):
        raise ValueError(f"width packing needs a stride-1 layers.Conv2d, got {conv!r}")
    with torch.device("meta"):
        packed = Conv2d(2 * conv.in_channels, 2 * conv.out_channels, conv.kernel_size[0],
                        bias=conv.bias is not None)
    packed.weight = nn.Parameter(pack_conv_weight_width(conv.weight.detach()),
                                 requires_grad=conv.weight.requires_grad)
    if conv.bias is not None:
        packed.bias = nn.Parameter(tile(conv.bias), requires_grad=conv.bias.requires_grad)
    return packed


def pack_hrnet_branch0(model):
    """A copy of a BN-folded HRNet (float or int8) whose every stage
    module's branch-0 basic-block conv1 / conv2 is width-packed (8 convs a
    module, 64 on W48) and whose `cfg` says `pack_branch0=True`, so that
    its forward packs branch 0's activations around those blocks. `model`
    is left as it was. Raises ValueError on a model with live BNs in those
    blocks (fold first) or one already packed."""
    if model.cfg.pack_branch0:
        raise ValueError("pack_hrnet_branch0: the model is already packed")
    packed = copy.deepcopy(model)
    for stage in (packed.stage2, packed.stage3, packed.stage4):
        for module in stage:
            for block in module.branches[0]:
                if not (isinstance(block.bn1, nn.Identity) and isinstance(block.bn2, nn.Identity)):
                    raise ValueError("pack_hrnet_branch0 requires a BN-folded model")
                block.conv1 = pack_conv_module_width(block.conv1)
                block.conv2 = pack_conv_module_width(block.conv2)
    packed.cfg = dataclasses.replace(model.cfg, pack_branch0=True)
    return packed
