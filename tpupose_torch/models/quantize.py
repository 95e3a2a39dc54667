"""Post-training int8 quantization of the conv backbones (serving mode).

Counterpart of `tpupose/models/quantize.py`, with its arithmetic in its
order:

* per-output-channel symmetric weight scales, w_scale = max|w| / 127
  (floored at 1e-12 / 127), or the `weight_mse` grid search;
* a per-tensor symmetric activation scale per conv from a calibration pass,
  x_scale = max(absmax / 127, 1e-12) in Python double, rounded to f32 once;
* zero-point 0 everywhere, so zero padding is exact;
* int32 accumulation, then dequantize and add the bias in f32, or
  requantize with relu straight to the next conv's int8 input.

A quantized conv is a `layers.QuantConv2d` (buffers `weight_q`, `w_scale`,
`x_scale`, `bias`, the JAX quantized dict's keys); `quantize_convs` returns
a new module with those in place of the calibrated `Conv2d`s and leaves the
float module as it was. Its forward is the JAX `quantized_conv_apply`.
Every int8 conv, the int8-resident blocks' included, is one call of
`tpupose_torch/ops/int8_conv.int8_conv`: kernel K2 on a CUDA tensor, its
plain version on a CPU tensor. The plain version's parts are the JAX
package's `_quant_input` (`quantize_input`), `_int8_conv` (`conv_exact`)
and the epilogues; `_requant_relu` is `epilogue(acc, *requant_vectors(..),
torch.int8)`.

Label-free distill-QAT (`distill_qat`) trains a fake-quant copy
(`fake_quant_convs`: `layers.FakeQuantConv2d`s, forward
`fake_quant_conv_apply`) with autograd and `torch.optim.Adam` to match the
float model's own outputs, each step a CUDA graph on the card
(`runtime.graphs.CapturedUpdate`), then `requantize_after_qat` turns it
into the int8 serving module. The other PTQ options are here too: cross-layer
equalization (`equalize_convs`, `quantize_hrnet(equalize=True)`),
MSE-optimal activation ranges (`calibrate_mse`), bias correction
(`record_bias_correction_means`, `bias_correct_convs`) and BN-statistics
re-estimation (`calibrate_bn_stats`). None of them has a kernel of its own:
as in the JAX package they are plain tensor ops, the f32 convolutions
`F.conv2d`.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.layers import (
    ActRecorder,
    BNStatRecorder,
    Conv2d,
    FakeQuantConv2d,
    QuantConv2d,
)
from tpupose_torch.ops.int8_conv import int8_conv
from tpupose_torch.ops.layout import memory_format_of
from tpupose_torch.runtime.graphs import CapturedUpdate, capturable

__all__ = [
    "ActRecorder",
    "QuantizationDriftError",
    "bias_correct_convs",
    "calibrate",
    "calibrate_bn_stats",
    "calibrate_mse",
    "distill_qat",
    "equalize_convs",
    "fake_quant_conv_apply",
    "fake_quant_convs",
    "hrnet_skip_ids",
    "is_quantized_conv",
    "quantize_convs",
    "quantize_hrnet",
    "quantize_yolo",
    "quantized_basic_block",
    "quantized_bottleneck",
    "record_bias_correction_means",
    "requant_vectors",
    "requantize_after_qat",
    "uncalibrated_scales",
    "yolo_detection_head_names",
    "yolo_skip_ids",
]


class QuantizationDriftError(RuntimeError):
    """The quantized model's outputs drifted beyond the accuracy gate on
    the calibration inputs (`Pipeline.quantize_models` self-check): serving
    it would be silently wrong."""


def _recorded(rec, apply_fn, batch):
    """`rec` after one inference forward `apply_fn(batch)` with it active."""
    ActRecorder.active = rec
    try:
        with torch.inference_mode():
            apply_fn(batch)
    finally:
        ActRecorder.active = None
    return rec


def calibrate(apply_fn, *batches, percentile=None, per_channel=False):
    """Run `apply_fn(batch)` over calibration batches, recording each conv's
    input range.

    Args:
      apply_fn: maps a batch to the model's output (e.g.
        `lambda x: model(x)`).
      *batches: one or more input batches.
      percentile: |x| percentile to map to int8 127 (None = absmax).
      per_channel: record a per-input-channel range vector per conv instead
        of a scalar.

    Returns:
      dict conv module -> float range (or numpy vector), the largest over
      the batches.
    """
    out = {}
    for batch in batches:
        rec = _recorded(ActRecorder(percentile=percentile, per_channel=per_channel),
                        apply_fn, batch)
        if not rec.taps:
            continue
        if per_channel:
            for conv, v in rec.taps:
                out[conv] = np.maximum(out.get(conv, 0.0), v.cpu().numpy())
        else:
            # one host fetch for all scales
            vals = torch.stack([v for _, v in rec.taps]).cpu().tolist()
            for (conv, _), v in zip(rec.taps, vals):
                out[conv] = max(out.get(conv, 0.0), float(v))
    return out


#: weight-scale MSE search grid (fractions of per-channel absmax); 1.0 is
#: always included so the search can never be worse than absmax.
_WEIGHT_MSE_GRID = tuple(np.linspace(0.4, 1.0, 13))


def _div127(a):
    """a / 127 as jitted XLA computes it: a times the f32 reciprocal of the
    constant (on either device)."""
    c127 = torch.full((), 127.0, device=a.device)
    return a * (torch.ones_like(c127) / c127)


def _quantize_conv(conv, absmax, weight_mse=False):
    """A `QuantConv2d` for float conv `conv` at input range `absmax`."""
    with torch.no_grad():
        w = conv.weight.to(torch.float32)  # OIHW
        a = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-12)
        if weight_mse:
            best_s, best_err = None, None
            for k in _WEIGHT_MSE_GRID:
                s = a * (k / 127.0)
                q = torch.clamp(torch.round(w / s[:, None, None, None]), -127, 127) * s[:, None, None, None]
                err = torch.sum((w - q) ** 2, dim=(1, 2, 3))
                if best_err is None:
                    best_err, best_s = err, s
                else:
                    best_s = torch.where(err < best_err, s, best_s)
                    best_err = torch.minimum(err, best_err)
            w_scale = best_s
        else:
            w_scale = _div127(a)
        # contiguous whatever the float weight's layout: the same buffers, and
        # bundle bytes, from a channels-last model as from an NCHW one
        weight_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]),
                               -127, 127).to(torch.int8).contiguous()
        x_scale = max(float(absmax) / 127.0, 1e-12)
        bias = None if conv.bias is None else conv.bias.detach().to(torch.float32).clone()
        return QuantConv2d(
            weight_q, w_scale,
            torch.tensor(x_scale, dtype=torch.float32, device=w.device), bias,
            stride=conv.stride[0], dilation=conv.dilation[0])


def quantize_convs(model: nn.Module, act_scales, skip=(), weight_mse=False) -> nn.Module:
    """A copy of `model` whose calibrated convs are `QuantConv2d`s.

    Args:
      model: BN-folded module (quantizing an unfolded conv would bake the
        pre-BN range into the scales; fold first).
      act_scales: dict from `calibrate` (conv module -> input absmax).
      skip: conv modules to keep in float.

    Returns a new module on the same device; `model` is left as it was.
    """
    skip = set(skip)
    plan = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m in act_scales and m not in skip:
            absmax = float(act_scales[m])
            plan[name] = lambda conv, a=absmax: _quantize_conv(conv, a, weight_mse)
    return _replace(model, plan)


def _replace(model, plan):
    """A deep copy of `model` with the submodule at each name of `plan`
    replaced by plan[name](that submodule of the copy)."""
    new = copy.deepcopy(model)
    for name, make in plan.items():
        parent, _, child = name.rpartition(".")
        owner = new.get_submodule(parent) if parent else new
        setattr(owner, child, make(new.get_submodule(name)))
    return new


def requant_vectors(p_from, p_to):
    """(mul, add) of the requant-relu epilogue (the JAX `_requant_relu`) at
    `p_to`'s input scale: w_scale * x_scale / next_x_scale and
    bias / next_x_scale."""
    mul = (p_from.w_scale * p_from.x_scale / p_to.x_scale).to(torch.float32)
    add = None if p_from.bias is None else p_from.bias / p_to.x_scale
    return mul, add


def is_quantized_conv(p):
    return isinstance(p, QuantConv2d)


def _requant_conv(p_from, p_to, x):
    """conv `p_from` on x (float, or int8 at its input scale) with the
    requant-relu epilogue into `p_to`'s int8 input."""
    return int8_conv(x, p_from.weight_q, p_from.weight_k, p_from.inv_scale(),
                     *requant_vectors(p_from, p_to), torch.int8)


def _dequant_conv(p, xq, dtype):
    """conv `p` on int8 input xq, dequantized to `dtype`."""
    return int8_conv(xq, p.weight_q, p.weight_k, None, *p.dequant_vectors(), dtype)


def quantized_basic_block(block, x):
    """int8-resident HRNet basic block (conv1 -> relu -> conv2 -> +skip ->
    relu): conv1's epilogue requantizes straight to conv2's int8 input, so
    the intermediate moves as int8. The residual stays in x's dtype. On a
    channels-last x the int8 intermediate is channels-last too, and conv2
    reads it without a quantize pass (no K2a on the card), as the JAX
    package's int8-resident blocks read their NHWC int8 input."""
    c1, c2 = block.conv1, block.conv2
    z = _dequant_conv(c2, _requant_conv(c1, c2, x), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(z + skip)


def quantized_bottleneck(block, x):
    """int8-resident bottleneck (conv1 -> relu -> conv2 -> relu -> conv3):
    both inter-conv tensors stay int8 (channels-last for a channels-last x:
    conv2 and conv3 run without K2a on the card)."""
    c1, c2, c3 = block.conv1, block.conv2, block.conv3
    out = _dequant_conv(c3, _requant_conv(c2, c3, _requant_conv(c1, c2, x)), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(out + skip)


def uncalibrated_scales(model: nn.Module, skip=()):
    """absmax=1 activation scales for every conv — timing only: the scales
    do not change the work; real serving must `calibrate`."""
    skip = set(skip)
    return {m: 1.0 for m in model.modules() if isinstance(m, Conv2d) and m not in skip}



# -- quantization-aware fine-tuning (QAT) -------------------------------------

def _clip127(t):
    """clip(t, -127, 127) with jnp.clip's gradient: max then min against
    tensor bounds, so an input exactly on a bound passes half the gradient
    (torch.clamp would pass all of it)."""
    lo = torch.full((), -127.0, dtype=t.dtype, device=t.device)
    return torch.minimum(torch.maximum(t, lo), -lo)


def _ste_qdq(t, s):
    """Quantize-dequantize with straight-through gradients: the forward sees
    the int8 grid, the backward identity."""
    q = _clip127(torch.round(t / s)) * s
    return t + (q - t).detach()


def _lsq_qdq(t, s):
    """Quantize-dequantize with LSQ gradients (Esser et al., "Learned Step
    Size Quantization"): only the round is straight-through, so autograd
    gives d/dt = 1 inside the clip range and 0 outside, and d/ds the
    rounding residual inside and +-127 outside. The forward value equals
    `_ste_qdq`'s."""
    s = torch.maximum(s, torch.full((), 1e-12, dtype=s.dtype, device=s.device))
    inv = t / s
    r = inv + (torch.round(inv) - inv).detach()
    return _clip127(r) * s


def fake_quant_convs(model: nn.Module, act_scales, skip=()) -> nn.Module:
    """A fake-quantized (QAT) copy of a BN-folded model.

    Each calibrated conv not in `skip` becomes a `FakeQuantConv2d` whose
    `fq_x_scale` starts at the calibrated input scale, max(absmax / 127,
    1e-12); it trains with LSQ gradients (`_lsq_qdq`). The weight scales are
    derived from the live weights in every forward, by the formula
    `quantize_convs` applies afterwards, so `requantize_after_qat`
    reproduces the trained forward. `model` is left as it was. Fine-tune
    without weight decay, which would shrink `fq_x_scale` regardless of its
    gradient.
    """
    skip = set(skip)
    plan = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m in act_scales and m not in skip:
            scale = max(float(act_scales[m]) / 127.0, 1e-12)
            plan[name] = lambda conv, scale=scale: FakeQuantConv2d.from_conv(conv, scale)
    return _replace(model, plan)


def fake_quant_conv_apply(conv: FakeQuantConv2d, x):
    """Forward of a fake-quant conv: the weights quantize-dequantized at
    their per-output-channel absmax / 127 scale (gradient-stopped) with
    straight-through gradients, the input at `fq_x_scale` with LSQ
    gradients, an f32 convolution, the bias added in f32, and the result in
    x's dtype and layout."""
    w = conv.weight.to(torch.float32)  # OIHW
    ws = torch.clamp(_div127(torch.amax(torch.abs(w.detach()), dim=(1, 2, 3))), min=1e-12)
    wq = _ste_qdq(w, ws[:, None, None, None]).contiguous(memory_format=memory_format_of(x))
    xq = _lsq_qdq(x.to(torch.float32), conv.fq_x_scale)
    kh, kw = w.shape[2], w.shape[3]
    y = F.conv2d(xq, wq, None, conv.stride, (kh // 2, kw // 2), conv.dilation)
    if conv.bias is not None:
        y = y + conv.bias.to(torch.float32)[:, None, None]
    return y.to(x.dtype)


def requantize_after_qat(fq_model: nn.Module) -> nn.Module:
    """The int8 serving copy of a QAT-trained fake-quant model: every
    `FakeQuantConv2d` becomes a `QuantConv2d` with weight scales from its
    trained weights (the fake-quant forward's formula) and its trained
    `fq_x_scale` as `x_scale`; other modules stay float."""
    def requantize(fq):
        q = _quantize_conv(fq, 0.0)
        q.x_scale = fq.fq_x_scale.detach().to(torch.float32).clone()
        return q

    return _replace(fq_model, {name: requantize for name, m in fq_model.named_modules()
                               if isinstance(m, FakeQuantConv2d)})


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def distill_loss(apply_fn, student, x, target):
    """The distillation loss: the mean over outputs of each output's mean
    squared error in f32 against `target`, the teacher's outputs on `x` as
    a list of f32 tensors."""
    errs = [torch.mean(torch.square(a.to(torch.float32) - t))
            for a, t in zip(_as_list(apply_fn(student, x)), target)]
    return sum(errs) / len(errs)


def distill_qat(apply_fn, folded, batches, steps=200, lr=1e-5, skip_ids=None, log=None):
    """Label-free quantization-aware fine-tuning by self-distillation.

    Fine-tunes a fake-quant copy of `folded` to match the float model's own
    outputs on the calibration batches (the quantity the int8 self-check
    measures), with straight-through gradients, then requantizes it into
    the int8 serving module. Needs no labels.

    Args:
      apply_fn: (model, x) -> output, a tensor or a list of tensors (YOLO's
        three head maps); e.g. `lambda m, x: m(x, torch.bfloat16)`.
      folded: BN-folded float model: the teacher and the student's start.
        It is left as it was.
      batches: list of calibration input batches on the model's device.
      steps: optimizer steps, cycling over the batches.
      lr: Adam learning rate (no weight decay; see `fake_quant_convs`).
      skip_ids: convs to keep float (default: none beyond uncalibrated).
      log: optional callable(step, loss), called every steps // 10 steps.

    Returns the requantized int8 serving module, its float convs' weights
    NCHW (the training layout; `Pipeline` restrides what it serves). The
    loss is `distill_loss`. Every parameter of the fake-quant copy trains: weights,
    biases, the float convs and each `fq_x_scale`.

    A step is one `runtime.graphs.CapturedUpdate`, the port's counterpart
    of the JAX package's jitted QAT step: on CUDA (Adam capturable there)
    each batch shape warms up for WARMUP steps, then replays one CUDA graph
    of forward, backward and Adam step (a shorter last batch is a second
    graph); on the CPU the same steps run eagerly, and so do they inside
    `runtime.graphs.disable_capture()`. The graphs and their memory are
    released before the function returns.
    """
    with torch.no_grad():
        # clones are normal tensors even where the batches were made under
        # inference_mode, which autograd could not save for backward; NCHW,
        # as every training path trains (a served model's channels-last
        # batches included)
        batches = [b.clone(memory_format=torch.contiguous_format) for b in batches]
    scales = calibrate(lambda x: apply_fn(folded, x), *batches)
    fq = fake_quant_convs(folded, scales, skip_ids or ()).to(memory_format=torch.contiguous_format)
    with torch.no_grad():
        targets = [[t.to(torch.float32) for t in _as_list(apply_fn(folded, b))]
                   for b in batches]

    params = list(fq.parameters())
    optimizer = torch.optim.Adam(params, lr=lr, capturable=capturable(params))

    def loss_fn(x, *target):
        return distill_loss(apply_fn, fq, x, target)

    step = CapturedUpdate(loss_fn, optimizer)
    for i in range(steps):
        b = i % len(batches)
        loss = step(batches[b], *targets[b])
        if log is not None and (i + 1) % max(1, steps // 10) == 0:
            log(i + 1, float(loss))
    step.release()
    optimizer.zero_grad(set_to_none=True)
    return requantize_after_qat(fq)


# -- further post-training options ---------------------------------------------

def _fused_pairs(model: nn.Module, channel_ranges):
    """(module name, producer, consumer, consumer input ranges) for each
    conv1 -> conv2 and conv2 -> conv3 pair of one module with only a folded
    BN (nn.Identity) and a ReLU between them, whose consumer has recorded
    per-channel ranges: the HRNet stem, every basic block and bottleneck."""
    pairs = []
    for name, node in model.named_modules():
        for k1, k2 in (("conv1", "conv2"), ("conv2", "conv3")):
            c1, c2 = getattr(node, k1, None), getattr(node, k2, None)
            if (isinstance(c1, Conv2d) and isinstance(c2, Conv2d)
                    and isinstance(getattr(node, "bn" + k1[4:], None), nn.Identity)
                    and c2 in channel_ranges):
                pairs.append((name, k1, k2, np.asarray(channel_ranges[c2], np.float32)))
    return pairs


def equalize_convs(model: nn.Module, channel_ranges, alpha=0.5) -> nn.Module:
    """Cross-layer equalization for the per-tensor activation scheme
    (SmoothQuant-style, data-informed).

    For a producer -> consumer pair separated only by a ReLU (positively
    homogeneous), scaling producer output channel c by 1/s_c and consumer
    input channel c by s_c is exact in float, and flattens the channel
    ranges of the activation between them:
    s_c = a_c^alpha / max|W2[:, c]|^(1 - alpha), a_c the channel's recorded
    |activation| range (`calibrate(..., per_channel=True)`), s_c = 1 where
    either is below 1e-9. Pairs as `_fused_pairs`; fuse and transition convs
    consume sums of several producers and are left alone.

    Returns a new module, float-equivalent to `model` up to its storage
    dtype's rounding; `model` is left as it was. Quantize after equalizing,
    calibrating the activation scales on the equalized model.
    """
    pairs = _fused_pairs(model, channel_ranges)
    new = copy.deepcopy(model)
    with torch.no_grad():
        for name, k1, k2, a in pairs:
            node = new.get_submodule(name) if name else new
            c1, c2 = getattr(node, k1), getattr(node, k2)
            w2 = c2.weight.to(torch.float32)
            w2max = torch.amax(torch.abs(w2), dim=(0, 2, 3))
            a_t = torch.as_tensor(a, device=w2.device)
            s = torch.where((a_t > 1e-9) & (w2max > 1e-9),
                            a_t ** alpha / torch.clamp(w2max, min=1e-9) ** (1.0 - alpha),
                            torch.ones_like(w2max))
            c1.weight.copy_(c1.weight.to(torch.float32) / s[:, None, None, None])
            if c1.bias is not None:
                c1.bias.copy_(c1.bias.to(torch.float32) / s)
            c2.weight.copy_(w2 * s[None, :, None, None])
    return new


def _qdq_const(xf, s):
    """clip(round(xf / s), -127, 127) * s for a Python float s, as jitted
    XLA computes it: the division becomes a product with the f32
    reciprocal of the f32 constant."""
    s = torch.full((), s, dtype=torch.float32, device=xf.device)
    return torch.clamp(torch.round(xf * (torch.ones_like(s) / s)), -127, 127) * s


class _MSERecorder(ActRecorder):
    """For every conv input with a recorded absmax, the quantize-dequantize
    MSE at each candidate range k * absmax; `calibrate_mse` picks the
    argmin per conv."""

    def __init__(self, absmax, candidates):
        super().__init__()
        self.absmax = absmax
        self.candidates = candidates

    def observe(self, conv, x):
        a = self.absmax.get(conv)
        if a is None:
            return
        xf = x.to(torch.float32)
        errs = []
        for k in self.candidates:
            q = _qdq_const(xf, max(float(a) * k / 127.0, 1e-12))
            errs.append(torch.mean(torch.square(xf - q)))
        self.taps.append((conv, torch.stack(errs)))


#: activation-range MSE search grid (fractions of absmax); includes 1.0 so
#: the search can never be worse than absmax on its own objective.
_ACT_MSE_GRID = tuple(np.linspace(0.35, 1.0, 14))


def calibrate_mse(apply_fn, *batches, candidates=_ACT_MSE_GRID):
    """MSE-optimal activation ranges: one absmax pass, then one pass that
    picks per conv the range k * absmax (k over `candidates`) minimizing
    E[(x - qdq(x))^2] summed over the batches. A drop-in replacement for
    `calibrate`; feed the result to `quantize_convs`."""
    absmax = calibrate(apply_fn, *batches)
    acc = {}
    for batch in batches:
        rec = _recorded(_MSERecorder(absmax, candidates), apply_fn, batch)
        if not rec.taps:
            continue
        vals = torch.stack([v for _, v in rec.taps]).cpu().numpy()
        for (conv, _), v in zip(rec.taps, vals):
            acc[conv] = acc.get(conv, 0.0) + v
    return {conv: float(absmax[conv]) * float(candidates[int(np.argmin(v))])
            for conv, v in acc.items()}


class _MeanRecorder(ActRecorder):
    """Each conv input's per-channel mean and the per-channel mean of its
    int8 quantize-dequantize image at the calibrated scale: the two first
    moments `bias_correct_convs` needs."""

    def __init__(self, act_scales):
        super().__init__()
        self.scales = act_scales

    def observe(self, conv, x):
        rng = self.scales.get(conv)
        if rng is None:
            return
        xf = x.to(torch.float32)
        xq = _qdq_const(xf, max(float(rng) / 127.0, 1e-12))
        self.taps.append((conv, (xf.mean(dim=(0, 2, 3)), xq.mean(dim=(0, 2, 3)))))


def record_bias_correction_means(apply_fn, batch, act_scales):
    """One forward collecting (E[x], E[qdq(x)]) per input channel for every
    conv of `act_scales` (keyed, as `calibrate`'s result, by conv module).
    Feed the result to `bias_correct_convs`."""
    rec = _recorded(_MeanRecorder(act_scales), apply_fn, batch)
    return {conv: (m.cpu().numpy(), mq.cpu().numpy()) for conv, (m, mq) in rec.taps}


def bias_correct_convs(model: nn.Module, qmodel: nn.Module, means) -> nn.Module:
    """Post-quantization bias correction (Nagel et al., data-free
    quantization): each quantized conv's systematic output error, per
    output channel

        sum_{cin, kh, kw} W_f[o, cin] E[x][cin] - W_dq[o, cin] E[qdq(x)][cin],

    added to its bias, from the input means `record_bias_correction_means`
    measured on `model` (exact for interior pixels; at the border both terms
    meet zero padding).

    Args:
      model: the BN-folded float model.
      qmodel: `quantize_convs(model, ...)` (same module names).
      means: dict float conv module -> (E[x], E[qdq(x)]) per input channel.

    Returns a new quantized module; skipped (float) convs are unchanged.
    """
    plan = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m in means and isinstance(qmodel.get_submodule(name),
                                                             QuantConv2d):
            plan[name] = (m, means[m])
    new = copy.deepcopy(qmodel)
    with torch.no_grad():
        for name, (conv, (mx, mxq)) in plan.items():
            q = new.get_submodule(name)
            dev = q.w_scale.device
            wf = conv.weight.to(device=dev, dtype=torch.float32)
            wdq = q.weight_q.to(torch.float32) * q.w_scale[:, None, None, None]
            mx, mxq = (torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
                       for v in (mx, mxq))
            corr = (torch.einsum("oihw,i->o", wf, mx)
                    - torch.einsum("oihw,i->o", wdq, mxq))
            q.bias = corr if q.bias is None else q.bias + corr
    return new


def calibrate_bn_stats(apply_fn, batch):
    """Re-estimate every BN's running mean and variance from data, in place
    (AdaBN-style): one forward in train-mode BN (`BNStatRecorder` active:
    each BN normalizes by its own input's batch statistics), then those
    statistics written into the running buffers. One pass is
    self-consistent (train-mode statistics depend on the batch alone); a
    passive tap written back in parallel would be a Jacobi iteration, which
    diverges on deep nets.

    Args:
      apply_fn: runs the unfolded model whose BN buffers are rewritten.
      batch: representative input batch.
    """
    rec = BNStatRecorder()
    BNStatRecorder.active = rec
    try:
        with torch.no_grad():
            apply_fn(batch)
    finally:
        BNStatRecorder.active = None
    with torch.no_grad():
        for bn, m, v in rec.taps:
            bn.running_mean.copy_(m)
            bn.running_var.copy_(v)


# -- model-level convenience --------------------------------------------------

def hrnet_skip_ids(model):
    """Convs to keep in float for HRNet: the final heatmap head (its output
    drives sub-pixel argmax refinement)."""
    return {model.final_layer}


def yolo_detection_head_names(cfg):
    """Names of the detection-head convs, selected structurally: the
    bias-carrying (bn=False) convs of the darknet spec."""
    return tuple(f"conv{i}" for i, (_, _, _, bn) in enumerate(cfg.conv_specs) if not bn)


def yolo_skip_ids(model, cfg):
    """Convs to keep in float for YOLOv3: the detection heads (box
    regression consumes their raw values)."""
    return {getattr(model, h).conv for h in yolo_detection_head_names(cfg)}


def quantize_hrnet(model, cfg, sample_batch, equalize=False, alpha=0.5,
                   compute_dtype=torch.bfloat16):
    """Calibrate on `sample_batch` ((N, 3, H, W) normalized crops) and
    quantize a BN-folded HRNet; returns the int8 copy.

    `equalize` first applies `equalize_convs` at `alpha` (float-exact) from
    per-channel ranges recorded on `sample_batch`, then calibrates the
    activation scales on the equalized model. Off by default, as in the JAX
    package: it is meant for learned checkpoints, whose post-ReLU channel
    ranges are heavy-tailed."""
    if equalize:
        ch = calibrate(lambda x: model(x, compute_dtype), sample_batch, per_channel=True)
        model = equalize_convs(model, ch, alpha)
    scales = calibrate(lambda x: model(x, compute_dtype), sample_batch)
    return quantize_convs(model, scales, hrnet_skip_ids(model))


def quantize_yolo(model, cfg, sample_batch, compute_dtype=torch.bfloat16):
    """Calibrate on `sample_batch` ((N, 3, S, S) network input in [0, 1])
    and quantize a BN-folded YOLOv3; returns the int8 copy."""
    scales = calibrate(lambda x: model(x, compute_dtype), sample_batch)
    return quantize_convs(model, scales, yolo_skip_ids(model, cfg))
