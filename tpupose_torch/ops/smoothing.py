"""Temporal Gaussian smoothing of pose history.

Counterpart of `tpupose/ops/smoothing.py`: the value at the last valid
element of `scipy.ndimage.gaussian_filter1d(history[:count], sigma,
mode='reflect')`, for a variable-length history, as a masked gather.
"""
from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float):
    """scipy.ndimage._gaussian_kernel1d with order=0, truncate=4.0."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), radius


#: (sigma, device) -> the kernel's weights on that device, copied once.
_WEIGHTS: dict = {}


def _weights(sigma: float, device):
    """`gaussian_kernel1d(sigma)` as a tensor on `device`. The copy to a
    card is made once, asynchronously from pinned memory, so a tracker step
    never waits on it."""
    w = _WEIGHTS.get((sigma, device))
    if w is None:
        with torch.inference_mode(False):
            w = torch.from_numpy(gaussian_kernel1d(sigma)[0])
            if device.type == "cuda":
                w = w.pin_memory().to(device, non_blocking=True)
        _WEIGHTS[(sigma, device)] = w
    return w


def _reflect_index(idx, n):
    """scipy 'reflect' (a b c d | d c b a) index folding, n >= 1."""
    period = 2 * n
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - 1 - m, m)


def smooth_last(history, count, sigma: float):
    """Smoothed value of element count-1 of a history buffer.

    Args:
      history: (H, ...) chronological buffer, or (B, H, ...) when `count`
        is a (B,) tensor.
      count: valid length >= 1 (int, 0-d or (B,) tensor).
    """
    count = torch.as_tensor(count, device=history.device)
    batched = count.dim() == 1
    if not batched:
        history, count = history[None], count.reshape(1)
    radius = gaussian_kernel1d(sigma)[1]
    taps = torch.arange(-radius, radius + 1, device=history.device)
    idx = _reflect_index(count[:, None] - 1 + taps[None, :], count[:, None])
    rest = history.shape[2:]
    idx = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    vals = torch.gather(history, 1, idx)  # (B, 2r+1, ...)
    w = _weights(sigma, history.device).reshape((1, -1) + (1,) * len(rest))
    out = torch.sum(vals * w, dim=1)
    return out if batched else out[0]


def smooth_last_pose(history, count, sigma: float, arm_sigma: float,
                     arm_joints=(9, 10)):
    """Newest pose of an (H, J, 3) or (B, H, J, 3) history, smoothed with
    `sigma` for the body and `arm_sigma` for the wrist joints."""
    body = smooth_last(history, count, sigma)
    arms = smooth_last(history, count, arm_sigma)
    joints = torch.arange(history.shape[-2], device=history.device)
    is_arm = torch.zeros_like(joints, dtype=torch.bool)
    for j in arm_joints:
        is_arm |= joints == j
    return torch.where(is_arm[:, None], arms, body)
