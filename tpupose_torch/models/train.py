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
optimizer state split over 'model' by output channel. On the card its step
is a CUDA graph too, its collectives inside, as the JAX package jits the
sharded step with its shardings.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn

from tpupose_torch.models.layers import BNStatRecorder, SyncBNStatRecorder
from tpupose_torch.runtime.graphs import CapturedUpdate, Layout, capturable

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
                 train_bn=False, bn_sync=None):
    """Joint-weighted MSE (standard JointsMSELoss) of `model(images)`.

    `train_bn` runs the BNs in train mode for this forward (each normalizes
    by its own input's batch statistics, through an active
    `layers.BNStatRecorder`; the previous recorder is restored after).
    Needed when training at real depth: inference-mode BN with raw init
    statistics lets the residual stacks double the activation variance per
    block, and with pre-calibrated statistics scales the gradients by tiny
    1 / sqrt(running_var) factors. With `bn_sync` = (process group, shares),
    the statistics are those of the whole batch over its ranks
    (`layers.SyncBNStatRecorder`)."""
    if train_bn:
        recorder = BNStatRecorder() if bn_sync is None else SyncBNStatRecorder(*bn_sync)
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


class ShardedTrainStep(CapturedUpdate):
    """step(images, targets, weights) -> the global batch's loss, over a
    ('data', 'model') mesh; see `make_sharded_train_step`.

    `tensors` holds this rank's trained tensors by name, the dim-0 slice of
    its 'model' index for each that `specs` splits (named in `split`), the
    whole tensor otherwise; `optimizer` holds them (its moments are slices
    too); `gather()` gives them whole. `collectives` counts the last call's
    by kind (`parallel.mesh.COUNTERS`): a call that makes a key, and every
    `eager` call, adds the batch-size all-gather.

    Buffers, fixed for the step's life, so that a CUDA graph reads and
    writes the same addresses at every replay: the local tensors are views
    of one flat parameter buffer, the split ones first, each at a multiple
    of `runtime.graphs.ALIGN` bytes; their `.grad` are views of one flat
    gradient buffer at the same offsets, with one more slot for the loss.
    The all-gather over 'model' reads the split part in place into a
    static (model, split) buffer, whose rows the forward reads as the whole
    tensors: views of it on a 'model' axis of 1, else one copy a tensor
    into a whole-tensor buffer, with one copy a tensor of this rank's rows
    of their gradients back."""

    def __init__(self, model, optimizer_factory, mesh, compute_dtype, train_bn):
        from tpupose_torch.parallel.mesh import conv_param_sharding

        self.model, self.mesh = model, mesh
        self.compute_dtype, self.train_bn = compute_dtype, train_bn
        named = named_trained_tensors(model)
        self.specs = conv_param_sharding(mesh, named)
        m, i = mesh.shape["model"], mesh.model_index
        dtypes = {t.dtype for _, t in named}
        if len(dtypes) != 1:
            raise ValueError(f"the trained tensors hold {sorted(map(str, dtypes))}: a sharded "
                             f"step keeps them in one flat buffer of one dtype")
        whole = dict(named)
        self.split = [name for name, _ in named if self.specs[name]]
        order = self.split + [name for name, _ in named if not self.specs[name]]
        local = {name: torch.empty((whole[name].shape[0] // m,) + whole[name].shape[1:]
                                   if self.specs[name] else whole[name].shape,
                                   dtype=whole[name].dtype, device="meta") for name in order}
        offsets, size = _offsets([local[name] for name in order])
        n_split = offsets[len(self.split)] if len(self.split) < len(order) else size
        device, dtype = mesh.device, dtypes.pop()
        self._params = torch.empty(size, dtype=dtype, device=device)
        self._grad_flat = torch.zeros(size + 1, dtype=dtype, device=device)
        self._loss_slot = self._grad_flat[size]
        views = {name: (off, local[name]) for name, off in zip(order, offsets)}
        self.tensors, self._forward_tensors = {}, {}
        with torch.no_grad():
            for name, t in named:
                off, like = views[name]
                view = self._params[off:off + like.numel()].view(like.shape)
                k = like.shape[0]
                view.copy_(t[i * k:(i + 1) * k] if self.specs[name] else t)
                self.tensors[name] = view.requires_grad_(True)
                self.tensors[name].grad = self._grad_flat[off:off + like.numel()].view(like.shape)
                if not self.specs[name]:
                    self._forward_tensors[name] = self.tensors[name]
        self._gathered = torch.empty((m, n_split), dtype=dtype, device=device)
        self._fills, self._row_copies = [], []
        if m == 1:  # the gathered row is the whole tensors; their gradients the local ones
            for name in self.split:
                off, like = views[name]
                self._forward_tensors[name] = leaf = (
                    self._gathered[0, off:off + like.numel()].view(like.shape).requires_grad_(True))
                leaf.grad = self.tensors[name].grad
        else:
            full = [whole[name] for name in self.split]
            whole_offsets, whole_size = _offsets(full)
            self._whole_flat = torch.empty(whole_size, dtype=dtype, device=device)
            self._whole_grads = torch.zeros(whole_size, dtype=dtype, device=device)
            for name, woff in zip(self.split, whole_offsets):
                off, like = views[name]
                n, shape = like.numel(), whole[name].shape
                rows = slice(woff, woff + m * n)
                self._fills.append((self._whole_flat[rows].view(m, n),
                                    self._gathered[:, off:off + n]))
                self._row_copies.append((self.tensors[name].grad.view(-1),
                                         self._whole_grads[rows].view(m, n)[i]))
                self._forward_tensors[name] = leaf = (
                    self._whole_flat[rows].view(shape).requires_grad_(True))
                leaf.grad = self._whole_grads[rows].view(shape)
        d = mesh.shape["data"]
        self._shares = torch.full((d,), 1.0 / d, dtype=torch.float32, device=device)
        self.optimizer = optimizer_factory(list(self.tensors.values()))
        self.collectives = {}
        super().__init__(self._loss, self.optimizer)

    def _gather_split(self):
        """The split tensors' slices, all-gathered over 'model' in one
        collective from the flat parameter buffer into the whole tensors."""
        from tpupose_torch.parallel.mesh import all_gather_into_

        with torch.no_grad():
            all_gather_into_(self._gathered, self._params[:self._gathered.shape[1]],
                             self.mesh.model_group)
            for dst, src in self._fills:
                dst.copy_(src)

    def gather(self):
        """Every trained tensor whole, by name (copies). A collective over
        'model': every rank of the group calls it."""
        self._gather_split()
        return {name: self._forward_tensors[name].detach().clone() for name in self.tensors}

    def _loss(self, images, targets, weights):
        from torch.func import functional_call

        self._gather_split()

        def forward(x, dtype):
            return functional_call(self.model, self._forward_tensors, (x, dtype))

        return heatmap_loss(forward, images, targets, weights, self.compute_dtype,
                            self.train_bn, bn_sync=(self.mesh.data_group, self._shares))

    def _zero_grads(self):
        self._grad_flat.zero_()
        if self._row_copies:
            self._whole_grads.zero_()

    def _reduce(self, loss):
        """This rank's rows of the split gradients into their slots, the loss
        into its own, one in-place all-reduce over 'data', divided by its
        size: the global batch's gradients and loss."""
        from tpupose_torch.parallel.mesh import all_reduce_sum_

        for dst, src in self._row_copies:
            dst.copy_(src)
        self._loss_slot.copy_(loss)
        all_reduce_sum_(self._grad_flat, self.mesh.data_group)
        self._grad_flat.div_(self.mesh.shape["data"])
        return self._loss_slot.clone()

    def _check_batch(self, images):
        """Every data rank's local batch size, all-gathered (a host read,
        outside any capture); unequal ones raise ValueError on every rank."""
        from tpupose_torch.parallel.mesh import all_gather_into_

        mesh = self.mesh
        n = torch.tensor([images.shape[0]], device=mesh.device)
        sizes = all_gather_into_(n.new_empty(mesh.shape["data"]), n, mesh.data_group).tolist()
        if len(set(sizes)) > 1:
            raise ValueError(f"the local batches differ over 'data' ({sizes} crops): "
                             f"the global loss is the mean of equal local batches")

    def _key(self, inputs):
        return super()._key(inputs) + ((self.mesh.shape["data"], self.mesh.shape["model"]),)

    def _new_key(self, key, inputs):
        self._check_batch(inputs[0])
        return super()._new_key(key, inputs)

    def _counted(self, fn, *inputs):
        from tpupose_torch.parallel import mesh as mesh_mod

        before = [getattr(mesh_mod, n) for n in mesh_mod.COUNTERS]
        try:
            return fn(*inputs)
        finally:
            self.collectives = {n: getattr(mesh_mod, n) - b
                                for n, b in zip(mesh_mod.COUNTERS, before)}

    def __call__(self, images, targets, weights):
        return self._counted(super().__call__, images, targets, weights)

    def eager(self, images, targets, weights):
        """One step on the caller's tensors, op by op, its batch sizes
        checked."""
        def step(*batch):
            self._check_batch(batch[0])
            return CapturedUpdate.eager(self, *batch)

        return self._counted(step, images, targets, weights)


def _offsets(tensors):
    """Element offsets of `tensors` (one dtype) laid out in one flat buffer,
    each at a multiple of `runtime.graphs.ALIGN` bytes, and the buffer's
    size."""
    if not tensors:
        return [], 0
    layout = Layout(tensors)
    size = tensors[0].element_size()
    return [off // size for off in layout.offsets], layout.nbytes // size


def make_sharded_train_step(model, optimizer_factory, mesh, compute_dtype=torch.float32,
                            train_bn=False):
    """The training step over a ('data', 'model') mesh
    (`parallel.mesh.make_mesh`); every rank of the mesh calls it with its
    own local batch. Returns (step, shardings_for), as the JAX package; the
    step is the port's counterpart of `jax.jit` with shardings.

    * Placement: each trained tensor (`named_trained_tensors(model)`) that
      `parallel.mesh.conv_param_sharding` splits lives on a rank as its
      dim-0 slice for the rank's 'model' index, and so do its optimizer
      moments and its update (AdamW and Adam are elementwise, so updating a
      slice equals slicing the full update); the others are replicated.
      `optimizer_factory(tensors)` builds the optimizer over the local
      tensors, views of one flat buffer (`make_optimizer`, or e.g.
      `partial(torch.optim.Adam, lr=1e-3)`). The model itself is left as
      it is.
    * A step: the split tensors are all-gathered whole over 'model' (one
      collective, from the flat parameter buffer), the forward runs through
      them (`torch.func.functional_call`) on the local batch, with
      synchronized train-mode BN under `train_bn` (one all-gather a BN,
      one reduce-scatter a BN in the backward: `layers.SyncBNStatRecorder`);
      after the backward the flat gradient buffer, each split tensor's own
      rows of its gradient and the loss, is all-reduced over 'data' in
      place and divided by its size; tensors that took no part keep zeros,
      as in `make_train_step`; then the optimizer steps. So a step issues
      2 + 2 x (BNs) collectives (586 for HRNet-W48 in train-mode BN).
    * On CUDA the step is one CUDA graph a key, collectives included, as
      `make_train_step`'s (`runtime.graphs.CapturedUpdate`): the key holds
      the device, the local batch's shapes and dtypes, the backend flags
      and the mesh's shape. A new key is made collectively: every rank
      all-gathers its local batch size once, outside any capture, and
      unequal sizes raise ValueError on every rank. Its first WARMUP calls
      run eagerly and issue every collective of the step on both groups
      (NCCL makes a group's communicator at its first collective, which
      must not fall inside a capture); the next captures and replays. So
      every rank must call the step the same number of times with the same
      key: a rank that captures while a peer still warms up deadlocks. The
      optimizer must be capturable there (others raise ValueError); a
      failed capture or replay raises. On the CPU (gloo) the same calls
      run the body op by op. `step.eager(...)` runs one step op by op on
      the card too, its batch sizes checked every call; `step.release()`
      hands the graphs' memory pool back.
    * The returned loss is the global batch's: the mean over 'data' of
      equal local batches.

    The model's conv compute is not split over 'model': every rank of a
    'model' group runs the same forward on the same batch. `compute_dtype`
    defaults to f32, as the JAX package's sharded step. `shardings_for(
    model_or_named_tensors)` gives the specs."""
    from tpupose_torch.parallel.mesh import conv_param_sharding

    return (ShardedTrainStep(model, optimizer_factory, mesh, compute_dtype, train_bn),
            partial(conv_param_sharding, mesh))
