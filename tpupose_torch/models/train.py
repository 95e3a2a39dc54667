"""Training step for the 2D pose backbone (heatmap regression).

Counterpart of `tpupose/models/train.py`: top-down pose fine-tuning, MSE over
per-joint Gaussian target heatmaps with per-joint visibility weights,
AdamW, inference-mode BN by default (`train_bn=True` normalizes by the batch
statistics instead). Tensors are NCHW: blob images (N, 3, H, W), targets
(N, J, Hh, Wh), as the port's HRNet reads and writes them.

What trains is what `jax.value_and_grad` trains in the JAX package: every
leaf of the parameter tree, and there the BN running statistics are leaves.
`trained_tensors` gives the module's parameters and its BN `running_mean` /
`running_var` buffers (made leaves that require grad), which is what an
optimizer from `make_optimizer` should hold. With `train_bn=True` the
statistics take no part in the forward; the step gives them zero gradients,
as JAX does, so AdamW's decoupled decay still moves them. Re-estimate them
with `quantize.calibrate_bn_stats` before folding.

The JAX package's `make_sharded_train_step` needs a device mesh and is not
defined here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpupose_torch.models.layers import BNStatRecorder

#: 17 visually distinct RGB colors, one per joint: joint identity is
#: learnable from color alone in the blob-localization task.
JOINT_COLORS = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
        [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
        [128, 128, 0],
    ],
    np.float32,
)


def blob_localization_batch(rng, cfg, n, blob_sigma=2.5, device=None):
    """Synthetic pose-localization batch: each joint is a distinct-colored
    Gaussian blob at a random position, drawn from the numpy Generator
    `rng` in the JAX package's order (so both packages make the same
    batch from the same seed).

    Returns (images (n, 3, H, W) f32 in [0, 1], keypoints (n, J, 3) crop
    px (x, y, 1)) on `device` (CUDA when None)."""
    from tpupose_torch.pipeline.facade import resolve_device

    device = resolve_device(device)
    h, w = cfg.input_size
    imgs = np.full((n, h, w, 3), 0.35, np.float32)
    kps = np.zeros((n, cfg.num_joints, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        for j in range(cfg.num_joints):
            x = rng.uniform(6, w - 6)
            y = rng.uniform(6, h - 6)
            kps[i, j] = (x, y, 1.0)
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * blob_sigma**2))
            color = JOINT_COLORS[j % len(JOINT_COLORS)]
            imgs[i] += blob[..., None] * (color / 255.0 - 0.35)
    images = torch.from_numpy(np.ascontiguousarray(np.clip(imgs, 0, 1).transpose(0, 3, 1, 2)))
    return images.to(device), torch.from_numpy(kps).to(device)


def gaussian_target_heatmaps(cfg, keypoints_crop, sigma=2.0):
    """Target heatmaps from (N, J, 3) keypoints (x, y, vis) in crop pixels.

    Returns heatmaps (N, J, Hh, Wh) and weights (N, J), on the keypoints'
    device."""
    hh, wh = cfg.heatmap_size
    dev = keypoints_crop.device
    xs = torch.arange(wh, dtype=torch.float32, device=dev)
    ys = torch.arange(hh, dtype=torch.float32, device=dev)
    kx = keypoints_crop[..., 0] / 4.0  # heatmap stride 4
    ky = keypoints_crop[..., 1] / 4.0
    gx = torch.exp(-0.5 * ((xs[None, None, :] - kx[..., None]) / sigma) ** 2)
    gy = torch.exp(-0.5 * ((ys[None, None, :] - ky[..., None]) / sigma) ** 2)
    heat = gy[:, :, :, None] * gx[:, :, None, :]
    weights = (keypoints_crop[..., 2] > 0).to(torch.float32)
    return heat, weights


def heatmap_loss(model, images, targets, weights, compute_dtype=torch.bfloat16,
                 train_bn=False):
    """Joint-weighted MSE (standard JointsMSELoss) of `model(images)`.

    `train_bn` runs the BNs in train mode for this forward (each normalizes
    by its own input's batch statistics, through an active
    `layers.BNStatRecorder`; the previous recorder is restored after).
    Needed when training at real depth: inference-mode BN with raw init
    statistics lets the residual stacks double the activation variance per
    block, and with pre-calibrated statistics scales the gradients by tiny
    1 / sqrt(running_var) factors."""
    if train_bn:
        prev, BNStatRecorder.active = BNStatRecorder.active, BNStatRecorder()
        try:
            pred = model(images, compute_dtype)
        finally:
            BNStatRecorder.active = prev
    else:
        pred = model(images, compute_dtype)
    err = (pred - targets) ** 2  # (N, J, Hh, Wh)
    per_joint = torch.mean(err, dim=(2, 3))  # (N, J)
    return torch.mean(per_joint * weights)


def trained_tensors(model: nn.Module):
    """The tensors a training step updates, as the JAX package's parameter
    tree holds them: every parameter, then every BN's `running_mean` and
    `running_var`, each made a leaf that requires grad (in place; call it
    after moving the model to its device)."""
    stats = []
    for m in model.modules():
        if not isinstance(m, nn.BatchNorm2d):
            continue
        for name in ("running_mean", "running_var"):
            t = m._buffers[name]
            if not t.is_leaf:
                t = m._buffers[name] = t.detach()
            stats.append(t.requires_grad_(True))
    return list(model.parameters()) + stats


def make_optimizer(params, lr=1e-3, weight_decay=1e-4):
    """AdamW over `params` (e.g. `trained_tensors(model)`), as
    `optax.adamw(lr, weight_decay=weight_decay)`: decoupled decay of every
    tensor it holds, eps outside the bias-corrected square root."""
    return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)


def make_train_step(model, optimizer, compute_dtype=torch.bfloat16, train_bn=False):
    """step(images, targets, weights) -> loss: one `heatmap_loss` forward and
    backward and one optimizer step, in place.

    Every tensor the optimizer holds that took no part in the forward (the
    BN statistics under `train_bn`) gets a zero gradient, as `jax.grad`
    gives it, so the optimizer still counts and decays it. The gradients
    stay in `.grad` until the next step. Works on a fake-quant model
    (`quantize.fake_quant_convs`) too."""
    tensors = [p for group in optimizer.param_groups for p in group["params"]]

    def step(images, targets, weights):
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = heatmap_loss(model, images, targets, weights, compute_dtype, train_bn)
            loss.backward()
        for p in tensors:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    return step
