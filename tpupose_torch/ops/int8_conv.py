"""int8 x int8 -> int32 convolution with fused quantization (kernel K2).

Counterpart of the int8 conv ops of `tpupose/models/quantize.py`
(`_quant_input`, `_int8_conv`, the dequantize epilogue of
`quantized_conv_apply`, `_requant_relu`), which the JAX package leaves to
XLA. Activations are NCHW, weights OIHW int8. One call computes

    acc = conv(q(x), weight_q)        int32, stride s, dilation d, pad k//2
    q(x) = clamp(round(x * inv), -127, 127) for a float x (0 for NaN),
           x for an int8 x
    out = acc * mul + add             to `out_dtype` (f32 / bf16), or
    out = clamp(round(acc * mul + add), 0, 127)  to int8 (requant-relu)

with `mul` and `add` per output channel (`add` may be None).

* `int8_conv_plain` is the plain torch version: an exact int32 conv
  (`F.conv2d` in float64 on int8 values: every partial sum is an integer
  below 2^53, so any summation order is exact) between the quantization and
  the epilogue, each rounding as the JAX package does.
* `int8_conv_cuda` launches the hand-written kernel
  (`tpupose_torch/csrc/int8_conv.cu`) on the weights in the layout it reads
  (`pack_weight`) and counts its launches in `launches`.
* `int8_conv` is what the models call: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, which raises rather than fall back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: Launches of the CUDA int8 conv kernel (reset freely; read by chip_smoke.py).
launches = 0

#: Tile of the kernel's weight operand: rows padded to BLOCK_N, K to BLOCK_K.
BLOCK_N = 64
BLOCK_K = 32

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round_up(v, m):
    return -(-v // m) * m


def pack_weight(weight_q):
    """(Cout, Cin, kh, kw) int8 -> the kernel's (Cout_pad, K_pad) int8 operand:
    row co is weight_q[co] flattened, zero-padded to K_pad = ceil(K/32)*32,
    and Cout is padded to a multiple of 64 with zero rows."""
    cout = weight_q.shape[0]
    k = weight_q[0].numel()
    out = torch.zeros((_round_up(cout, BLOCK_N), _round_up(k, BLOCK_K)),
                      dtype=torch.int8, device=weight_q.device)
    out[:cout, :k] = weight_q.reshape(cout, k)
    return out


def out_size(size, k, stride=1, dilation=1):
    """Output extent of a conv padded k//2 on both sides."""
    return (size + 2 * (k // 2) - dilation * (k - 1) - 1) // stride + 1


def quantize_input(x, inv):
    """clamp(round(x * inv), -127, 127) as int8; the product in f32, round
    half to even (as jnp.round), NaN to 0 (as XLA converts it to int8)."""
    q = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8)


def conv_exact(xq, weight_q, stride=1, dilation=1):
    """int8 x int8 -> int32 conv, exact: float64 on int8 values. cuDNN is
    kept out on the card, whose algorithms may transform the operands."""
    kh, kw = weight_q.shape[2], weight_q.shape[3]
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xq.to(torch.float64), weight_q.to(torch.float64),
                     stride=stride, padding=(kh // 2, kw // 2), dilation=dilation)
    return y.to(torch.int32)


def epilogue(acc, mul, add, out_dtype):
    """int32 accumulators -> acc * mul (+ add) per output channel, rounded
    after each operation; cast to `out_dtype`, or requantized with relu to
    int8 when `out_dtype` is torch.int8."""
    y = acc.to(torch.float32) * mul[:, None, None]
    if add is not None:
        y = y + add[:, None, None]
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y), 0, 127).to(torch.int8)
    return y.to(out_dtype)


def int8_conv_plain(x, weight_q, inv, mul, add, out_dtype, stride=1, dilation=1):
    """The plain torch version of the kernel (see the module docstring)."""
    xq = x if x.dtype == torch.int8 else quantize_input(x, inv)
    return epilogue(conv_exact(xq, weight_q, stride, dilation), mul, add, out_dtype)


def _kernel():
    from tpupose_torch import kernels

    fn = kernels.library("int8_conv").tpupose_int8_conv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def int8_conv_cuda(x, weight_k, kernel_hw, inv, mul, add, out_dtype, stride=1,
                   dilation=1):
    """One launch of the hand-written kernel.

    Args:
      x: (N, Cin, H, W) contiguous f32, bf16 or int8 on a CUDA device.
      weight_k: `pack_weight(weight_q)`, on the same device.
      kernel_hw: (kh, kw) of weight_q.
      inv: 1-element f32 tensor 1 / x_scale (ignored for an int8 x).
      mul, add: (Cout,) f32 (add may be None).
      out_dtype: torch.float32 / torch.bfloat16 (dequantize) or torch.int8
        (requantize-relu).
    Launches on the current stream, does not synchronize, and raises on
    anything the kernel does not take and on a failed launch.
    """
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int8_conv_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"int8_conv_cuda takes f32 / bf16 / int8, got "
                        f"{x.dtype} -> {out_dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"int8_conv_cuda needs a contiguous NCHW input, got "
                         f"{tuple(x.shape)}")
    n, cin, h, w = x.shape
    kh, kw = kernel_hw
    cout = mul.shape[0]
    kpad = _round_up(cin * kh * kw, BLOCK_K)
    if (weight_k.dtype != torch.int8 or weight_k.device != dev
            or tuple(weight_k.shape) != (_round_up(cout, BLOCK_N), kpad)
            or not weight_k.is_contiguous()):
        raise ValueError(f"int8_conv_cuda: packed weight {tuple(weight_k.shape)} "
                         f"{weight_k.dtype} does not fit Cin={cin} k={kh}x{kw} "
                         f"Cout={cout}")
    vectors = [mul] + ([] if add is None else [add])
    if x.dtype != torch.int8:
        vectors.append(inv.reshape(1))
    for v in vectors:
        if v.dtype != torch.float32 or v.device != dev or not v.is_contiguous():
            raise ValueError("int8_conv_cuda: inv, mul and add must be "
                             "contiguous f32 on the input's device")
    if add is not None and add.shape != mul.shape:
        raise ValueError(f"int8_conv_cuda: add {tuple(add.shape)} != mul "
                         f"{tuple(mul.shape)}")
    ho, wo = out_size(h, kh, stride, dilation), out_size(w, kw, stride, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv_cuda: empty output for {h}x{w} input")
    if max(cin * h * w, cout * ho * wo) >= 2**31:
        raise ValueError("int8_conv_cuda: one image must hold fewer than 2^31 "
                         "elements in and out")
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=dev)
    if n == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), _CODES[x.dtype], weight_k.data_ptr(),
                None if x.dtype == torch.int8 else inv.data_ptr(),
                mul.data_ptr(), None if add is None else add.data_ptr(),
                y.data_ptr(), _CODES[out_dtype], n, cin, h, w, cout, kh, kw,
                stride, kh // 2, kw // 2, dilation, ho, wo, kpad, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {rc}")
    launches += 1
    return y


def int8_conv(x, weight_q, weight_k, inv, mul, add, out_dtype, stride=1,
              dilation=1):
    """Dispatch for the models: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor (raising on failure)."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight_q, inv, mul, add, out_dtype, stride,
                               dilation)
    return int8_conv_cuda(x.contiguous(), weight_k, tuple(weight_q.shape[2:]),
                          inv, mul, add, out_dtype, stride, dilation)
