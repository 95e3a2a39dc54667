"""Conv-net primitives for the port's networks.

Counterpart of `tpupose/models/layers.py`. Activations have PyTorch's
logical (N, C, H, W) shape and conv weights (O, I, H, W); module and
parameter names follow torch state_dict conventions (`weight`, `bias`,
`running_mean`, `running_var`), as the JAX package's trees do. Every layer
follows the memory layout of its input (`ops.layout`): a channels-last
input (the JAX package's NHWC, what `Pipeline` serves) gives a
channels-last output, an NCHW input an NCHW one. `to_channels_last`
restrides a model's float conv weights once, so that the served convs find
their weights in the input's layout.

* `Conv2d` pads k//2 on both sides (torch padding, also at stride 2) and
  computes in the input's dtype, casting its weights as the JAX
  `conv_apply` does.
* `BatchNorm2d` is inference-mode BN with the JAX package's arithmetic
  (x * inv + (beta - mean * inv), inv = gamma / sqrt(var + eps)).
* `fold_batchnorm` absorbs every (conv, bn) pair into the conv.
* `QuantConv2d` is the int8 serving conv (the JAX package's quantized conv
  dict, with the same keys); `Conv2d.forward` reports its input to an
  active `ActRecorder` for calibration (`tpupose_torch.models.quantize`).
* `FakeQuantConv2d` is the QAT conv (the JAX package's fake-quant conv
  dict: `weight`, `bias`, `fq_x_scale`), whose forward is
  `quantize.fake_quant_conv_apply`.
* While a `BNStatRecorder` is active, `bn_apply` normalizes by the batch
  statistics of its input and records them (`quantize.calibrate_bn_stats`);
  a `SyncBNStatRecorder` takes them over a process group's whole batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.ops.int8_conv import int8_conv, pack_weight
from tpupose_torch.ops.layout import memory_format_of


def conv_apply(weight, bias, x, stride=1, dilation=1):
    """Conv with torch padding (k//2 per side) in x's dtype and layout (the
    weight is copied only where its layout differs from x's)."""
    kh, kw = weight.shape[2], weight.shape[3]
    w = weight.to(x.dtype).contiguous(memory_format=memory_format_of(x))
    return F.conv2d(
        x, w, None if bias is None else bias.to(x.dtype),
        stride=stride, padding=(kh // 2, kw // 2), dilation=dilation,
    )


@torch.no_grad()
def to_channels_last(model: nn.Module) -> nn.Module:
    """Restride every float conv weight of `model` to channels-last, in
    place, and return the model: the served layout, done once. Values,
    shapes and state_dict keys stay the same; int8 buffers (`weight_q`) are
    left contiguous, so that a bundle written from the model holds the same
    bytes as one from an NCHW model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
    return model


class BNStatRecorder:
    """Collects per-BN input batch statistics during one forward.

    While a recorder is `active`, `bn_apply` normalizes by the statistics of
    the current batch (train-mode BN) instead of the running ones and
    reports them here, so one pass gives self-consistent statistics: every
    BN's input is already normalized by everything upstream, as it will be
    once they are written back. Taps are (bn module, mean, population
    variance), in f32 over (N, H, W).
    """

    active = None

    def __init__(self):
        self.taps = []  # (bn module, mean, var)

    def observe(self, bn, x):
        xf = x.to(torch.float32)
        m = xf.mean(dim=(0, 2, 3))
        v = torch.square(xf - m[:, None, None]).mean(dim=(0, 2, 3))  # as jnp.var
        self.taps.append((bn, m, v))
        return m, v


def merge_bn_stats(shares, means, variances, residuals):
    """The statistics of a batch from those of its d parts, by Chan et al.'s
    parallel merge: `shares` (d,) the parts' fractions of the batch (summing
    to 1); `means`, `variances` and `residuals` (d, C) each part's f32 mean
    m_i, its mean square deviation from m_i, and the mean of those
    deviations r_i (what the f32 rounding of m_i left out: m_i + r_i is the
    part's mean to f32 precision). Returns (mean, variance), (C,):

        m = sum_i s_i m_i,
        v = sum_i s_i var_i + sum_i s_i (m_i - m) (m_i - m + 2 r_i),

    the mean square deviation from m, exactly so in exact arithmetic. Each
    m_i - m is exact in f32, and every term is a part's own two-pass
    statistic, so v keeps the two-pass accuracy where a channel's mean
    dwarfs its spread, which E[x^2] - E[x]^2 loses; and so does the spread
    of the part means, which the f32 m_i alone round away (there the
    rounding of m_i is of the order of m_i - m). Over one part of share 1
    it is the identity, bit for bit, and so is its gradient: the correction
    term and its gradients are exact zeros.
    (A residual's own gradient is zero in exact arithmetic: callers pass it
    detached.)"""
    s = shares[:, None]
    m = (s * means).sum(dim=0)
    dev = means - m
    # the small between-part terms summed apart, then rounded into the sum
    # of variances once (not once a part)
    between = (s * dev * torch.add(dev, residuals, alpha=2)).sum(dim=0)
    return m, (s * variances).sum(dim=0) + between


class SyncBNStatRecorder(BNStatRecorder):
    """A `BNStatRecorder` whose statistics are those of the whole batch
    over the ranks of a process group (synchronized train-mode BN), as the
    JAX package's `jnp.mean` / `jnp.var` over a data-sharded batch, which
    XLA turns into psums. The ranks' inputs share (C, H, W); `shares` (d,)
    holds each group rank's fraction of the batch (`models.train.
    ShardedTrainStep` gives 1 / d, its local batches being equal).

    Each BN computes this rank's two-pass statistics in f32 over (N, H, W),
    as `BNStatRecorder.observe`, and the mean of the deviations, gathers
    the (3, C) block of mean, variance and mean deviation from every rank in
    one differentiable all-gather (`parallel.mesh.all_gather`, whose
    backward is one SUM reduce-scatter), and merges the rows with
    `merge_bn_stats`, the same on every rank. So each BN costs one
    collective in the forward and one in the backward. On one rank the
    merge is the identity, and the statistics and their gradients are
    `BNStatRecorder`'s bit for bit: train-mode BN's are ill-conditioned
    where a channel's mean dwarfs its spread, and a last-bit change there
    moves its gradients by up to 1e-2.
    """

    def __init__(self, group, shares):
        super().__init__()
        self.group = group
        self.shares = shares

    def observe(self, bn, x):
        from tpupose_torch.parallel.mesh import all_gather

        xf = x.to(torch.float32)
        m = xf.mean(dim=(0, 2, 3))
        dev = xf - m[:, None, None]
        v = torch.square(dev).mean(dim=(0, 2, 3))
        r = dev.detach().mean(dim=(0, 2, 3))  # the f32 mean's rounding: its gradient is 0
        rows = all_gather(torch.stack((m, v, r)), self.group)  # (d, 3, C)
        m, v = merge_bn_stats(self.shares, *rows.unbind(1))
        self.taps.append((bn, m, v))
        return m, v


def bn_apply(bn, x, eps=1e-5):
    """Batch norm over dimension 1 with frozen statistics, or with the
    batch's own while a `BNStatRecorder` is active."""
    if BNStatRecorder.active is not None:
        m, v = BNStatRecorder.active.observe(bn, x)
    else:
        m, v = bn.running_mean.float(), bn.running_var.float()
    inv = torch.rsqrt(v + eps) * bn.weight.float()
    shift = bn.bias.float() - m * inv
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class ActRecorder:
    """Collects per-conv input range statistics during one forward.

    While a recorder is `active`, every `Conv2d.forward` calls
    `observe(conv, x)`; taps are keyed by the conv module. `percentile=None`
    records absmax, a float the `percentile`-th percentile of |x| (linear
    interpolation, as jnp.quantile); `per_channel` records a vector over
    input channels instead of a scalar.
    """

    active = None

    def __init__(self, percentile=None, per_channel=False):
        self.taps = []  # (conv module, range tensor)
        self.percentile = percentile
        self.per_channel = per_channel

    def observe(self, conv, x):
        if self.percentile is None:
            dims = (0, 2, 3) if self.per_channel else None
            v = (x.abs().amax(dim=dims) if dims else x.abs().amax()).to(torch.float32)
        else:
            a = x.to(torch.float32).abs()
            a = a.transpose(0, 1).reshape(a.shape[1], -1) if self.per_channel else a.reshape(1, -1)
            v = quantile_linear(a, self.percentile / 100.0)
            v = v if self.per_channel else v[0]
        self.taps.append((conv, v))


def quantile_linear(a, q):
    """jnp.quantile(a, q, axis=1) with linear interpolation, in f32, on a
    2-D tensor (torch.quantile refuses more than 2^24 elements): the
    position q * (n - 1) in f32, low and high order statistics by kthvalue,
    low * (1 - w) + high * w."""
    n = a.shape[1]
    f32 = dict(dtype=torch.float32)
    pos = torch.tensor(q, **f32) * (torch.tensor(float(n), **f32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo = int(min(max(float(low), 0), n - 1))
    hi = int(min(max(float(high), 0), n - 1))
    lo_v = torch.kthvalue(a, lo + 1, dim=1).values
    hi_v = lo_v if hi == lo else torch.kthvalue(a, hi + 1, dim=1).values
    return lo_v * w_low.to(a.device) + hi_v * w_high.to(a.device)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with padding k//2 that computes in the input's dtype and
    reports its input to an active `ActRecorder`."""

    def __init__(self, cin, cout, k, stride=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=bias)

    def forward(self, x):
        if ActRecorder.active is not None:
            ActRecorder.active.observe(self, x)
        return conv_apply(self.weight, self.bias, x, self.stride, self.dilation)


class QuantConv2d(nn.Module):
    """int8 serving conv: the JAX package's quantized conv dict as buffers.

    `weight_q` (Cout, Cin, kh, kw) int8, `w_scale` (Cout,) f32, `x_scale` 0-d
    f32 and, where the float conv had one, `bias` (Cout,) f32: the state_dict
    keys equal the quantized JAX tree's key paths. `weight_k` is the kernel's
    layout of `weight_q` (`ops.int8_conv.pack_weight`), kept out of the
    state_dict and rebuilt whenever one is loaded. The forward is the JAX
    `quantized_conv_apply`: it quantizes its input at `x_scale`, convolves
    in int8 with int32 sums, dequantizes per channel, adds the bias and
    casts to the input's dtype, in one `ops.int8_conv.int8_conv` call (K2
    on the card, its plain version on the CPU). Move it with `.to(device)`
    only: a dtype cast would round the scales.
    """

    def __init__(self, weight_q, w_scale, x_scale, bias=None, stride=1, dilation=1):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("x_scale", x_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("weight_k", pack_weight(weight_q), persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.weight_k = pack_weight(self.weight_q)

    def inv_scale(self):
        """1 / x_scale in f32 (IEEE quotient on either device)."""
        return torch.ones_like(self.x_scale) / self.x_scale

    def dequant_vectors(self):
        """(mul, add) of the dequantize epilogue: w_scale * x_scale and bias."""
        return (self.w_scale * self.x_scale).to(torch.float32), self.bias

    def forward(self, x):
        return int8_conv(x, self.weight_q, self.weight_k, self.inv_scale(),
                         *self.dequant_vectors(), x.dtype, self.stride, self.dilation)


class FakeQuantConv2d(Conv2d):
    """QAT conv: a `Conv2d` with a trainable 0-d f32 `fq_x_scale` parameter
    (the JAX package's fake-quant conv dict, same keys). Its forward
    simulates the int8 serving conv in f32 with straight-through gradients
    (`quantize.fake_quant_conv_apply`) and reports to no recorder. It is not
    a `QuantConv2d`, so an int8-resident block never fuses it. Built only
    by `from_conv`."""

    @classmethod
    def from_conv(cls, conv: Conv2d, fq_x_scale: float) -> "FakeQuantConv2d":
        """A fake-quant conv that takes over `conv`'s weight and bias
        parameters, with `fq_x_scale` rounded to f32 once."""
        with torch.device("meta"):
            fq = cls(conv.in_channels, conv.out_channels, conv.kernel_size[0],
                     conv.stride[0], conv.bias is not None)
        fq.dilation = conv.dilation
        fq.weight, fq.bias = conv.weight, conv.bias
        fq.fq_x_scale = nn.Parameter(
            torch.tensor(fq_x_scale, dtype=torch.float32, device=conv.weight.device))
        return fq

    def forward(self, x):
        from tpupose_torch.models.quantize import fake_quant_conv_apply

        return fake_quant_conv_apply(self, x)


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
    """Max pool with TF 'SAME' padding, like the JAX reduce_window, in x's
    layout (`F.pad` may return another)."""
    fmt = memory_format_of(x)
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=-torch.inf).contiguous(memory_format=fmt)
    return F.max_pool2d(x, window, stride)


def upsample_nearest(x, factor):
    """Nearest-neighbour upsample by an integer factor (x's layout)."""
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
