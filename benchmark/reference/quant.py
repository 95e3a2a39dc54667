"""Post-training quantization for the reference: symmetric integer convs
at any bit width, their scales worked out here from the calibration
inputs.

Per-output-channel weight scales absmax / q, one activation scale per
conv from the largest |input| it sees on the calibration batch (absmax /
q), zero points 0, q = 2^(bits - 1) - 1 (127 for int8, 7 for int4).
The integer products are summed exactly in float64 (every partial sum of
int8 x int8 products at these widths is an integer far below 2^53), then
scaled back to float32 with the bias added. The convs named in `skip`
(the detector's heads, the pose net's heatmap layer) stay float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def calibrate(forward, conv, x, names):
    """{name: largest |input| over x} for the convs in `names`, from one
    float forward `forward(recording_conv, x)`."""
    seen = {}

    def recording(name, inp):
        if name in names:
            seen[name] = max(seen.get(name, 0.0), float(inp.abs().amax()))
        return conv(name, inp)

    with torch.no_grad():
        forward(recording, x)
    return seen


def quantized_conv(specs, folded, absmax, bits):
    """conv(name, x) that runs the convs in `absmax` as `bits`-bit integer
    convs and the others in float32."""
    q = float(2 ** (bits - 1) - 1)
    stride = {s.name: s.stride for s in specs}
    params = {}
    for name, a in absmax.items():
        w, b = folded[name]
        w64 = w.double()
        ws = torch.clamp(w64.abs().amax(dim=(1, 2, 3)), min=1e-12) / q
        wq = torch.clamp(torch.round(w64 / ws[:, None, None, None]), -q, q)
        params[name] = (wq, ws, max(a / q, 1e-12), b.double())

    def conv(name, x):
        if name not in params:
            w, b = folded[name]
            return F.conv2d(x, w, b, stride[name], w.shape[-1] // 2)
        wq, ws, xs, b = params[name]
        xq = torch.clamp(torch.round(x.double() / xs), -q, q)
        xq = torch.nan_to_num(xq, nan=0.0)
        acc = F.conv2d(xq, wq, None, stride[name], wq.shape[-1] // 2)
        return (acc * (ws * xs)[:, None, None] + b[:, None, None]).float()

    return conv
