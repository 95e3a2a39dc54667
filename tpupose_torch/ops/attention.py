"""Multi-head softmax attention for the ViT pose network.

Counterpart of nothing in the JAX package (it has no transformer).

    out = softmax(q kᵀ · scale) v

over (N, heads, T, d) tensors, every head and image apart.

* `attention_plain` is the plain version: the scores, their softmax and
  the product with v written out in float32, cast back to q's dtype.
* `attention_cuda` is PyTorch's fused `scaled_dot_product_attention`
  restricted to its fused backends (flash, cuDNN, memory-efficient), which
  never write the (N, heads, T, T) scores to memory. It raises where none
  of them serves the inputs, rather than take the math backend, which
  would write them (640 x 16 x 192 x 192 scores a ViT-H layer of a clip).
  It counts its calls in `launches`.
* `attention` is what the model calls: a CPU tensor goes to the plain
  version, a CUDA tensor to the fused one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Calls of the fused attention (reset freely; read by the benchmark).
launches = 0


def attention_plain(q, k, v, scale):
    """softmax(q kᵀ · scale) v in float32 over (..., T, d) tensors; the
    result in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def attention_cuda(q, k, v, scale):
    """`attention_plain` as one fused attention call on CUDA tensors of
    shape (N, heads, T, d) with unit stride in d. Launches on the current
    stream, does not synchronize, and raises where no fused backend serves
    the inputs."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda needs CUDA tensors, got {q.device}")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    launches += 1
    return out


def attention(q, k, v, scale):
    """Dispatch for the model: the plain version for a CPU tensor, the
    fused one for a CUDA tensor (raising where it cannot serve)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return attention_cuda(q, k, v, scale)
