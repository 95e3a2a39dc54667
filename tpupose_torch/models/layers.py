"""Conv-net primitives for the port's networks.

Counterpart of `tpupose/models/layers.py`. Inside the networks activations
are NCHW and conv weights OIHW (PyTorch's layout); module and parameter
names follow torch state_dict conventions (`weight`, `bias`,
`running_mean`, `running_var`), as the JAX package's trees do.

* `Conv2d` pads k//2 on both sides (torch padding, also at stride 2) and
  computes in the input's dtype, casting its weights as the JAX
  `conv_apply` does.
* `BatchNorm2d` is inference-mode BN with the JAX package's arithmetic
  (x * inv + (beta - mean * inv), inv = gamma / sqrt(var + eps)).
* `fold_batchnorm` absorbs every (conv, bn) pair into the conv.
The int8 and fake-quant conv paths of the JAX package are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv_apply(weight, bias, x, stride=1, dilation=1):
    """Conv with torch padding (k//2 per side) in x's dtype."""
    kh, kw = weight.shape[2], weight.shape[3]
    return F.conv2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride=stride, padding=(kh // 2, kw // 2), dilation=dilation,
    )


def bn_apply(bn, x, eps=1e-5):
    """Inference-mode batch norm with frozen statistics (NCHW)."""
    inv = torch.rsqrt(bn.running_var.float() + eps) * bn.weight.float()
    shift = bn.bias.float() - bn.running_mean.float() * inv
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d with padding k//2 that computes in the input's dtype."""

    def __init__(self, cin, cout, k, stride=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=bias)

    def forward(self, x):
        return conv_apply(self.weight, self.bias, x, self.stride, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference-mode BN in the JAX package's arithmetic; state_dict keys
    are nn.BatchNorm2d's."""

    def forward(self, x):
        return bn_apply(self, x, self.eps)


def fold_batchnorm(model: nn.Module, dtype=None) -> nn.Module:
    """Fold every (conv, bn) pair into the conv, in place, for inference.

    w' = w * s and b' = beta - mean * s (+ b * s if the conv had a bias),
    s = gamma / sqrt(var + eps), computed in f32; the BN becomes
    nn.Identity, so its keys leave the state_dict as the JAX package's
    folded trees drop them. Pairs are siblings named convN / bnN, conv /
    bn, or i / i+1 (Sequential). `dtype` then casts every parameter
    (e.g. torch.bfloat16 serving weights). Returns the model.
    """
    for module in list(model.modules()):
        children = module._modules
        for name in list(children):
            conv = children[name]
            if not isinstance(conv, nn.Conv2d):
                continue
            if name.startswith("conv") and name != "conv":
                partner = "bn" + name[4:]
            elif name == "conv":
                partner = "bn"
            elif name.isdigit():
                partner = str(int(name) + 1)
            else:
                continue
            bn = children.get(partner)
            if not isinstance(bn, nn.BatchNorm2d):
                continue
            with torch.no_grad():
                s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
                b = bn.bias.float() - bn.running_mean.float() * s
                if conv.bias is not None:
                    b = b + conv.bias.float() * s
                w = conv.weight.float() * s[:, None, None, None]
            conv.weight = nn.Parameter(w.to(conv.weight.dtype))
            conv.bias = nn.Parameter(b.to(bn.bias.dtype))
            children[partner] = nn.Identity()
    if dtype is not None:
        model.to(dtype)
    return model


def max_pool(x, window=2, stride=2):
    """Max pool with TF 'SAME' padding (NCHW), like the JAX reduce_window."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=-torch.inf)
    return F.max_pool2d(x, window, stride)


def upsample_nearest(x, factor):
    """Nearest-neighbour upsample by an integer factor (NCHW)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def leaky_relu(x, slope=0.1):
    return F.leaky_relu(x, negative_slope=slope)


@torch.no_grad()
def he_normal_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """He-normal conv weights (std sqrt(2 / fan_in)), zero conv biases and
    identity BN statistics, drawn from `generator` (the JAX package's
    `conv_init` / `bn_init` distribution; the numbers themselves differ)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
