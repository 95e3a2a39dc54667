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

Not ported yet (queued in ROADMAP.md): distill-QAT (`fake_quant_convs`,
`_lsq_qdq`, `distill_qat`, `requantize_after_qat`), `equalize_convs`,
`calibrate_mse`, bias correction and `calibrate_bn_stats`.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.layers import ActRecorder, Conv2d, QuantConv2d
from tpupose_torch.ops.int8_conv import int8_conv

__all__ = [
    "ActRecorder",
    "QuantizationDriftError",
    "calibrate",
    "hrnet_skip_ids",
    "is_quantized_conv",
    "quantize_convs",
    "quantize_hrnet",
    "quantize_yolo",
    "quantized_basic_block",
    "quantized_bottleneck",
    "requant_vectors",
    "uncalibrated_scales",
    "yolo_detection_head_names",
    "yolo_skip_ids",
]


class QuantizationDriftError(RuntimeError):
    """The quantized model's outputs drifted beyond the accuracy gate on
    the calibration inputs (`Pipeline.quantize_models` self-check): serving
    it would be silently wrong."""


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
        rec = ActRecorder(percentile=percentile, per_channel=per_channel)
        ActRecorder.active = rec
        try:
            with torch.inference_mode():
                apply_fn(batch)
        finally:
            ActRecorder.active = None
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
            # XLA turns the JAX package's `a / 127.0` into a product with the
            # f32 reciprocal of the constant; so does this, on either device
            c127 = torch.full((), 127.0, device=a.device)
            w_scale = a * (torch.ones_like(c127) / c127)
        weight_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]),
                               -127, 127).to(torch.int8)
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
    plan = {name: float(act_scales[m]) for name, m in model.named_modules()
            if isinstance(m, Conv2d) and m in act_scales and m not in skip}
    new = copy.deepcopy(model)
    for name, absmax in plan.items():
        parent, _, child = name.rpartition(".")
        owner = new.get_submodule(parent) if parent else new
        setattr(owner, child, _quantize_conv(new.get_submodule(name), absmax, weight_mse))
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
    the intermediate moves as int8. The residual stays in x's dtype."""
    c1, c2 = block.conv1, block.conv2
    z = _dequant_conv(c2, _requant_conv(c1, c2, x), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(z + skip)


def quantized_bottleneck(block, x):
    """int8-resident bottleneck (conv1 -> relu -> conv2 -> relu -> conv3):
    both inter-conv tensors stay int8."""
    c1, c2, c3 = block.conv1, block.conv2, block.conv3
    out = _dequant_conv(c3, _requant_conv(c2, c3, _requant_conv(c1, c2, x)), x.dtype)
    skip = x if block.downsample is None else block.downsample(x)
    return F.relu(out + skip)


def uncalibrated_scales(model: nn.Module, skip=()):
    """absmax=1 activation scales for every conv — timing only: the scales
    do not change the work; real serving must `calibrate`."""
    skip = set(skip)
    return {m: 1.0 for m in model.modules() if isinstance(m, Conv2d) and m not in skip}


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
    quantize a BN-folded HRNet; returns the int8 copy."""
    if equalize:
        raise NotImplementedError(
            "equalize=True needs equalize_convs (cross-layer equalization), "
            "which is not ported to tpupose_torch yet (queued in ROADMAP.md)")
    scales = calibrate(lambda x: model(x, compute_dtype), sample_batch)
    return quantize_convs(model, scales, hrnet_skip_ids(model))


def quantize_yolo(model, cfg, sample_batch, compute_dtype=torch.bfloat16):
    """Calibrate on `sample_batch` ((N, 3, S, S) network input in [0, 1])
    and quantize a BN-folded YOLOv3; returns the int8 copy."""
    scales = calibrate(lambda x: model(x, compute_dtype), sample_batch)
    return quantize_convs(model, scales, yolo_skip_ids(model, cfg))
