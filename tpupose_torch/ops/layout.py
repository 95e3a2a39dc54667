"""Memory layout of 4-D activations: NCHW or channels-last.

The JAX package computes stage A in NHWC (`dimension_numbers=("NHWC",
"HWIO", "NHWC")`). The port keeps PyTorch's logical (N, C, H, W) shapes and
serves with NHWC strides (`torch.channels_last`): `Pipeline` converts its
models' conv weights once (`models.layers.to_channels_last`) and hands the
networks channels-last views of its NHWC crops and images, and every layer
follows the layout of its input. An NCHW input runs the NCHW code.
"""
from __future__ import annotations

import torch


def is_channels_last(x) -> bool:
    """True for a 4-D tensor with NHWC strides that is not also NCHW
    contiguous (a tensor that is both, H = W = 1 or C = 1, counts as NCHW)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def memory_format_of(x):
    """torch.channels_last for a channels-last `x`, else
    torch.contiguous_format."""
    return torch.channels_last if is_channels_last(x) else torch.contiguous_format
