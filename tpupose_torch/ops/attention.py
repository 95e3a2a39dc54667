"""Multi-head softmax attention for the transformer pose networks.

Counterpart of nothing in the JAX package (it has no transformer).

    out = softmax(q kᵀ · scale + bias) v

over (N, heads, T, d) tensors, every head and image apart; `bias` is an
optional additive (heads, T, T) term broadcast over N (HRFormer's relative
position bias; ViTPose has none).

* `attention_plain` is the plain version: the scores, the bias, their
  softmax and the product with v written out in float32, cast back to q's
  dtype.
* `attention_cuda` is PyTorch's fused `scaled_dot_product_attention`
  restricted to its fused backends (flash, cuDNN, memory-efficient), which
  never write the (N, heads, T, T) scores to memory. It raises where none
  of them serves the inputs, rather than take the math backend, which
  would write them (640 x 16 x 192 x 192 scores a ViT-H layer of a clip).
  A head dim that is not a multiple of 8 (which the memory-efficient and
  cuDNN backends refuse) is zero-padded to one, the scale given as the
  unpadded dim's: the padded q and k columns add exact zeros to every
  score and the padded v columns give zero output columns, which are cut
  off. A bias is handed over as a float mask of q's dtype, stored with its
  last dim padded to a multiple of 8 (`pad_bias`) so that PyTorch need not
  pad it at each call. It counts its calls in `launches`.
* `attention` is what the models call: a CPU tensor goes to the plain
  version, a CUDA tensor to the fused one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Calls of the fused attention (reset freely; read by the benchmark).
launches = 0

#: Head dims and a bias's last dim go to the fused kernels in multiples of this.
ALIGN = 8


def pad_bias(bias):
    """A (heads, T, T) bias as a view of a (heads, T, T') tensor, T' the
    next multiple of ALIGN: the layout the fused kernels read a mask in."""
    t = bias.shape[-1]
    return F.pad(bias, (0, -t % ALIGN))[..., :t]


def attention_plain(q, k, v, scale, bias=None):
    """softmax(q kᵀ · scale + bias) v in float32 over (..., T, d) tensors;
    the result in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    if bias is not None:
        s = s + bias.float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def attention_cuda(q, k, v, scale, bias=None):
    """`attention_plain` as one fused attention call on CUDA tensors of
    shape (N, heads, T, d), d <= 128, with unit stride in d. Launches on the
    current stream, does not synchronize, and raises where no fused
    backend serves the inputs."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda needs CUDA tensors, got {q.device}")
    d = q.shape[-1]
    if d > 128:
        raise ValueError(f"attention_cuda takes head dims up to 128, got {d}")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    pad = -d % ALIGN
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    mask = None
    if bias is not None:
        mask = bias.to(q.dtype)
        if mask.stride(-2) % ALIGN:
            mask = pad_bias(mask)
        mask = mask.expand(q.shape[0], *mask.shape)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    launches += 1
    return out[..., :d] if pad else out


def attention(q, k, v, scale, bias=None):
    """Dispatch for the model: the plain version for a CPU tensor, the
    fused one for a CUDA tensor (raising where it cannot serve)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, bias)
    return attention_cuda(q, k, v, scale, bias)
