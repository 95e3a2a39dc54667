"""One pass after a conv: bias, nearest upsample, residual and activation.

Counterpart of nothing in the JAX package, whose convs XLA fuses with what
follows them (see `tpupose_torch/csrc/epilogue.cu`). On PyTorch each of
these is a pass over the conv's output of its own; here they are one:

    out = act(src[n, c, h >> up, w >> up] + bias[c] + skip[n, c, h, w])

every term optional, rounded to the tensors' dtype after each step as the
composed ops round: up in 0..3 reads a coarser src by nearest neighbour;
act is None, "relu", "leaky" (leaky ReLU at LEAKY_SLOPE) or "gelu" (exact
erf GELU, `F.gelu`, in f32 as PyTorch computes it); `act_first` applies
the activation before the skip (Darknet's `x + act(conv(x))`, HRFormer's
FFN `x + gelu(bn(fc2(h)))`).

* `bias_act_plain` is the plain torch version, the composed ops themselves
  (a conv's bias add as cuDNN's path in PyTorch adds it, a separate add).
* `bias_act_cuda` launches the hand-written kernel on channels-last bf16 or
  f32 tensors with C % 8 == 0, or of any C without an upsample where the
  output holds a multiple of 8 elements (`serves`), and counts its
  launches in `launches`.
* `bias_act` is what the models call: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, which raises rather than fall
  back; a call with nothing to do returns `src` itself.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: Launches of the epilogue kernel (reset freely; read by chip_smoke.py).
launches = 0

LEAKY_SLOPE = 0.1
#: Channel granule of the kernel: 8 channels move as one 16-byte vector.
CHANNELS = 8

_ACTS = {None: 0, "relu": 1, "leaky": 2, "gelu": 3}
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _act(y, act):
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    if act == "leaky":
        return F.leaky_relu(y, negative_slope=LEAKY_SLOPE)
    if act == "gelu":
        return F.gelu(y)
    raise ValueError(f"unknown activation {act!r}")


def bias_act_plain(src, bias=None, skip=None, up=0, act=None, act_first=False):
    """The composed ops (see the module docstring): the bias add, the
    nearest upsample, then the activation and the skip add in the order
    `act_first` says."""
    y = src
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    if up:
        y = F.interpolate(y, scale_factor=2 ** up, mode="nearest")
    if act_first:
        y = _act(y, act)
    if skip is not None:
        y = y + skip
    return y if act_first else _act(y, act)


def _kernel():
    from tpupose_torch import kernels

    fn = kernels.library("epilogue").tpupose_bias_act_nhwc
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _channels_last(t):
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def serves(channels, elements, up=0):
    """True where the kernel takes an output of `channels` channels and
    `elements` elements: C % 8 == 0, or, without an upsample, any C where
    the output holds a multiple of 8 elements (its flat mode)."""
    return channels % CHANNELS == 0 or (not up and elements % CHANNELS == 0)


def bias_act_cuda(src, bias=None, skip=None, up=0, act=None, act_first=False):
    """`bias_act_plain` as one launch of the hand-written kernel.

    src: (N, C, h, w) channels-last bf16 or f32 on a CUDA device, C % 8 ==
    0 or (no upsample) N C h w % 8 == 0; bias: (C,) on it (cast to src's
    dtype); skip: (N, C, h << up, w << up) channels-last of src's dtype, or
    None. Every tensor 16-byte aligned and the output below 2^34 elements.
    Returns a new channels-last tensor of the output's shape. Launches on the current stream, does not
    synchronize, and raises on anything else and on a failed launch.
    """
    global launches
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"bias_act_cuda needs CUDA tensors, got {dev}")
    if src.dtype not in _CODES:
        raise TypeError(f"bias_act_cuda takes bf16 or f32, got {src.dtype}")
    if act not in _ACTS or up not in (0, 1, 2, 3):
        raise ValueError(f"bias_act_cuda: act {act!r}, up {up!r}")
    n, c, h, w = src.shape if src.dim() == 4 else (0, 0, 0, 0)
    shape = (n, c, h << up, w << up)
    if not _channels_last(src) or not serves(c, n * c * shape[2] * shape[3], up):
        raise ValueError(f"bias_act_cuda needs a channels-last (N, C, H, W) src with C % 8 "
                         f"== 0 (or, without an upsample, 8k elements), got "
                         f"{tuple(src.shape)} strides {src.stride()}, up {up}")
    if skip is not None and (skip.device != dev or skip.dtype != src.dtype
                             or tuple(skip.shape) != shape or not _channels_last(skip)):
        raise ValueError(f"bias_act_cuda: skip {tuple(skip.shape)} {skip.dtype} does not "
                         f"match the output {shape} {src.dtype}, channels-last")
    if bias is not None:
        if bias.device != dev or tuple(bias.shape) != (c,):
            raise ValueError(f"bias_act_cuda: bias {tuple(bias.shape)} on {bias.device} "
                             f"for {c} channels on {dev}")
        bias = bias.to(src.dtype).contiguous()
    if n * c * shape[2] * shape[3] >= 2**34:
        raise ValueError("bias_act_cuda: the output must hold fewer than 2^34 elements")
    out = torch.empty(shape, dtype=src.dtype, device=dev, memory_format=torch.channels_last)
    if any(t.data_ptr() % 16 for t in (src, skip, out) if t is not None):
        raise ValueError("bias_act_cuda needs 16-byte aligned tensors")
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _kernel()(src.data_ptr(), None if bias is None else bias.data_ptr(),
                       None if skip is None else skip.data_ptr(), out.data_ptr(),
                       _CODES[src.dtype], n, shape[2], shape[3], c, up, _ACTS[act],
                       int(act_first), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def bias_act(src, bias=None, skip=None, up=0, act=None, act_first=False):
    """Dispatch for the models: `src` itself where there is nothing to do,
    the plain version for a CPU tensor, the kernel for a CUDA tensor
    (raising on failure)."""
    if bias is None and skip is None and not up and act is None:
        return src
    if src.device.type == "cpu":
        return bias_act_plain(src, bias, skip, up, act, act_first)
    return bias_act_cuda(src, bias, skip, up, act, act_first)
