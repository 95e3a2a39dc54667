"""Training step for the 2D pose backbone (heatmap regression).

Counterpart of `tpupose/models/train.py`: top-down pose fine-tuning, MSE over
per-joint Gaussian target heatmaps with per-joint visibility weights,
AdamW, inference-mode BN by default (`train_bn=True` normalizes by the batch
statistics instead). Tensors are NCHW: blob images (N, 3, H, W), targets
(N, J, Hh, Wh), as the port's HRNet reads and writes them. On the card a
step of `make_train_step` replays one CUDA graph of forward, backward and
optimizer step (`runtime.graphs.CapturedUpdate`), as the JAX package jits it.

What trains is what `jax.value_and_grad` trains in the JAX package: every
leaf of the parameter tree, and there the BN running statistics are leaves.
`trained_tensors` gives the module's parameters and its BN `running_mean` /
`running_var` buffers (made leaves that require grad), which is what an
optimizer from `make_optimizer` should hold. With `train_bn=True` the
statistics take no part in the forward; the step gives them zero gradients,
as JAX does, so AdamW's decoupled decay still moves them. Re-estimate them
with `quantize.calibrate_bn_stats` before folding.

`make_sharded_train_step` trains over a ('data', 'model') mesh of ranks
(`parallel.mesh.make_mesh`): the batch split over 'data' with train-mode
BN synchronized over the whole of it, and the conv parameters with their
optimizer state split over 'model' by output channel.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpupose_torch.models.layers import BNStatRecorder, SyncBNStatRecorder
from tpupose_torch.runtime.graphs import CapturedUpdate, capturable

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
                 train_bn=False, bn_group=None):
    """Joint-weighted MSE (standard JointsMSELoss) of `model(images)`.

    `train_bn` runs the BNs in train mode for this forward (each normalizes
    by its own input's batch statistics, through an active
    `layers.BNStatRecorder`; the previous recorder is restored after).
    Needed when training at real depth: inference-mode BN with raw init
    statistics lets the residual stacks double the activation variance per
    block, and with pre-calibrated statistics scales the gradients by tiny
    1 / sqrt(running_var) factors. With a process group `bn_group`, the
    statistics are those of the whole batch over its ranks
    (`layers.SyncBNStatRecorder`)."""
    if train_bn:
        recorder = BNStatRecorder() if bn_group is None else SyncBNStatRecorder(bn_group)
        prev, BNStatRecorder.active = BNStatRecorder.active, recorder
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


def named_trained_tensors(model: nn.Module):
    """(name, tensor) pairs of `trained_tensors(model)`, in its order (the
    BN statistics by their state_dict names), leaving the module as it is."""
    stats = [(f"{name}.{b}", m._buffers[b]) for name, m in model.named_modules()
             if isinstance(m, nn.BatchNorm2d) for b in ("running_mean", "running_var")]
    return list(model.named_parameters()) + stats


def make_optimizer(params, lr=1e-3, weight_decay=1e-4):
    """AdamW over `params` (e.g. `trained_tensors(model)`), as
    `optax.adamw(lr, weight_decay=weight_decay)`: decoupled decay of every
    tensor it holds, eps outside the bias-corrected square root.
    Capturable on CUDA (`runtime.graphs.capturable`): its step count and
    bias corrections live on the card, in f32, as optax's do."""
    params = list(params)
    return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay,
                             capturable=capturable(params))


def make_train_step(model, optimizer, compute_dtype=torch.bfloat16, train_bn=False):
    """step(images, targets, weights) -> loss: one `heatmap_loss` forward and
    backward and one optimizer step, in place; the port's counterpart of
    `jax.jit` over the JAX package's train step.

    On a CUDA model the step is a `runtime.graphs.CapturedUpdate`: its
    first WARMUP calls for a batch shape (and backend flags) run eagerly,
    the next captures forward, backward and optimizer step as one CUDA
    graph and replays it, and every later call copies the batch in and
    replays. The optimizer must be capturable there (`make_optimizer` is;
    others raise ValueError). On the CPU the same calls run the body
    eagerly. `step.eager(...)` runs the step on its arguments op by op.

    Every tensor the optimizer holds has a gradient from the first call on:
    the step zeroes it in place and the backward accumulates into it, so
    one that took no part in the forward (the BN statistics under
    `train_bn`) gets a zero gradient, as `jax.grad` gives it, and the
    optimizer still counts and decays it. The gradients stay in `.grad`
    until the next step. Works on a fake-quant model
    (`quantize.fake_quant_convs`) too."""

    def loss_fn(images, targets, weights):
        return heatmap_loss(model, images, targets, weights, compute_dtype, train_bn)

    return CapturedUpdate(loss_fn, optimizer)


class ShardedTrainStep:
    """step(images, targets, weights) -> the global batch's loss, over a
    ('data', 'model') mesh; see `make_sharded_train_step`.

    `tensors` holds this rank's trained tensors by name: the dim-0 slice of
    its 'model' index for each that `specs` splits, the whole tensor
    otherwise; `optimizer` holds them (its moments are slices too);
    `gather()` gives them whole; `collectives` counts the last step's."""

    def __init__(self, model, optimizer_factory, mesh, compute_dtype, train_bn):
        from tpupose_torch.parallel.mesh import conv_param_sharding

        self.model, self.mesh = model, mesh
        self.compute_dtype, self.train_bn = compute_dtype, train_bn
        named = named_trained_tensors(model)
        self.specs = conv_param_sharding(mesh, named)
        m, i = mesh.shape["model"], mesh.model_index
        self.tensors = {}
        for name, t in named:
            t = t.detach()
            if self.specs[name]:
                k = t.shape[0] // m
                t = t[i * k:(i + 1) * k]
            self.tensors[name] = t.to(mesh.device, copy=True).requires_grad_(True)
        self.split = [name for name in self.tensors if self.specs[name]]
        self.optimizer = optimizer_factory(list(self.tensors.values()))
        self.collectives = {}

    def _gather_split(self):
        """The split tensors whole: their slices in one flat buffer, one
        all-gather over 'model', each cut back out (row r of the gathered
        buffer is rank r's slices)."""
        m = self.mesh.shape["model"]
        flat = torch.cat([self.tensors[name].detach().reshape(-1) for name in self.split])
        rows = flat.new_empty(m * flat.numel())
        dist.all_gather_into_tensor(rows, flat, group=self.mesh.model_group)
        rows = rows.view(m, -1)
        full, off = {}, 0
        for name in self.split:
            t = self.tensors[name]
            full[name] = rows[:, off:off + t.numel()].reshape((m * t.shape[0],) + t.shape[1:])
            off += t.numel()
        return full

    def gather(self):
        """Every trained tensor whole, by name (copies)."""
        full = self._gather_split()
        return {name: full.get(name, t.detach().clone()) for name, t in self.tensors.items()}

    def __call__(self, images, targets, weights):
        from torch.func import functional_call

        from tpupose_torch.parallel import mesh as mesh_mod

        mesh, d = self.mesh, self.mesh.shape["data"]
        bn_before = mesh_mod.all_reduces
        n = torch.tensor([images.shape[0]], device=mesh.device)
        sizes = n.new_empty(d)
        dist.all_gather_into_tensor(sizes, n, group=mesh.data_group)
        sizes = sizes.tolist()
        if len(set(sizes)) > 1:
            raise ValueError(f"the local batches differ over 'data' ({sizes} crops): "
                             f"the global loss is the mean of equal local batches")
        self.optimizer.zero_grad(set_to_none=True)
        full = {name: t.requires_grad_(True) for name, t in self._gather_split().items()}
        tensors = {name: full.get(name, t) for name, t in self.tensors.items()}

        def forward(x, dtype):
            return functional_call(self.model, tensors, (x, dtype))

        with torch.enable_grad():
            loss = heatmap_loss(forward, images, targets, weights, self.compute_dtype,
                                self.train_bn, bn_group=mesh.data_group)
            loss.backward()
        i, grads = mesh.model_index, []
        for name, t in self.tensors.items():
            g = tensors[name].grad
            if g is None:  # took no part in the forward: zero, as jax.grad gives
                g = torch.zeros_like(t)
            elif name in full:
                g = g[i * t.shape[0]:(i + 1) * t.shape[0]]
            grads.append(g.reshape(-1))
        bucket = torch.cat(grads + [loss.detach().reshape(1)])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=mesh.data_group)
        bucket /= d
        off = 0
        for t in self.tensors.values():
            t.grad = bucket[off:off + t.numel()].view_as(t)
            off += t.numel()
        self.optimizer.step()
        self.collectives = {"batch_size_all_gather": 1, "param_all_gather": 1,
                            "grad_all_reduce": 1,
                            "bn_all_reduces": mesh_mod.all_reduces - bn_before}
        return bucket[-1]


def make_sharded_train_step(model, optimizer_factory, mesh, compute_dtype=torch.float32,
                            train_bn=False):
    """The training step over a ('data', 'model') mesh
    (`parallel.mesh.make_mesh`); every rank of the mesh calls it with its
    own local batch. Returns (step, shardings_for), as the JAX package.

    * Placement: each trained tensor (`named_trained_tensors(model)`) that
      `parallel.mesh.conv_param_sharding` splits lives on a rank as its
      dim-0 slice for the rank's 'model' index, and so do its optimizer
      moments and its update (AdamW and Adam are elementwise, so updating a
      slice equals slicing the full update); the others are replicated.
      `optimizer_factory(tensors)` builds the optimizer over the local
      tensors (`make_optimizer`, or e.g. `partial(torch.optim.Adam,
      lr=1e-3)`).
    * A step: the split tensors are all-gathered whole over 'model' (one
      collective, their slices in one buffer), the forward runs through
      them (`torch.func.functional_call`) on the local batch, with
      synchronized train-mode BN under `train_bn`; after the backward the
      gradients, each split tensor's own slice of its gradient, and the
      loss are averaged over 'data' in one all-reduce; tensors that took
      no part get zeros, as in `make_train_step`; then the optimizer steps.
    * The returned loss is the global batch's: the mean over 'data' of
      equal local batches (unequal ones raise, on every rank).

    The model's conv compute is not split over 'model': every rank of a
    'model' group runs the same forward on the same batch. `compute_dtype`
    defaults to f32, as the JAX package's sharded step. `shardings_for(
    model_or_named_tensors)` gives the specs."""
    from tpupose_torch.parallel.mesh import conv_param_sharding

    return (ShardedTrainStep(model, optimizer_factory, mesh, compute_dtype, train_bn),
            partial(conv_param_sharding, mesh))
